"""Training of the port: step builders and the adaptive trainer
(the paper's Algorithm 1)."""
