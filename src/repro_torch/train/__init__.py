"""Train→deploy artifacts of the port (``train/promote.py``)."""
