"""Command-line entry points (the port's counterparts of ``vidsgg/cli``)."""
