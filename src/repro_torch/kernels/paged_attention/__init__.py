"""Paged decode attention: plain version (``ref``), CUDA kernel and binding (``csrc``, ``paged_attention``), wrapper (``ops``)."""
