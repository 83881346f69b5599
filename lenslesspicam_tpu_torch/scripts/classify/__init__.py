"""The port's ``scripts/classify`` app: the ViT classifier on
reconstructions."""
