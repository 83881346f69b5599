"""The port's ``scripts/measure`` apps."""
