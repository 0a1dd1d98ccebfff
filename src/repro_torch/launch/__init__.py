"""Entry points of the port's model stack."""
