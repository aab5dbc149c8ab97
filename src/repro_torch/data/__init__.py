"""Data of the port: the deterministic synthetic LM pipeline."""
