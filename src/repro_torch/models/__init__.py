"""Model definitions of the port: configs, layers, the full language models."""
