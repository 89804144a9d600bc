"""Entry points of the port: the LM training driver (``train.py``)."""
