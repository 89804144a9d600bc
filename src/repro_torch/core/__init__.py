"""Selection core of the port: proxies, OMP, GRAD-MATCH and the strategy
dispatch."""
