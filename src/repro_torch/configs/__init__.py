"""Configurations of the port (copies of ``repro/configs``)."""
