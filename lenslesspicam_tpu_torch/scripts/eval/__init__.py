"""The port's ``scripts/eval`` apps."""
