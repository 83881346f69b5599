"""The port's ``scripts/recon`` apps."""
