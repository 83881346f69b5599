"""The port's ``scripts/sim`` apps."""
