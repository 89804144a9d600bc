"""Models of the port (the classifier of the paper's experiments)."""
