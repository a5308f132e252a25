"""Command-line entry points of the port (``python3 -m ...cli.eval``)."""
