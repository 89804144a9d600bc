"""Fault kinds and bounded retry for the streaming engine, after
``repro/resilience/``."""
