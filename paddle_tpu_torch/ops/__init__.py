"""Plain tensor ops of the port (``attention.py``: the naive attention
route)."""
