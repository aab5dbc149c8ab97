"""Model definitions of the port (dense family)."""
