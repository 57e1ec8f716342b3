"""Scripts of the port, run by hand with ``python -m``."""
