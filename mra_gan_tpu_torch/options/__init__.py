"""Command-line flags of the port's drivers."""
