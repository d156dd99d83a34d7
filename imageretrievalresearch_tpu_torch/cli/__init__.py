"""Command-line entry points of the port: ``cli.gallery``,
``cli.data_split``, ``cli.train`` and ``cli.find_lr``."""
