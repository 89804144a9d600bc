"""Models of the port: the classifier of the paper's experiments and the
dense LMs (``lm.py`` with ``attention.py`` and ``ffn.py``)."""
