"""Command-line entry points of the port: ``cli.gallery``,
``cli.data_split``, ``cli.train``, ``cli.find_lr`` and ``cli.inference``."""
