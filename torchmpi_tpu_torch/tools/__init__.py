"""One-off measurement scripts for the port, run as ``python -m``."""
