"""Data of the port: the seeded synthetic classification mixture and the
weighted-subset loader."""
