"""Command-line entry points of the port (``cli.gallery``)."""
