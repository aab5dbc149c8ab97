"""Flash attention: plain version (``ref``), CUDA kernel and binding (``csrc``, ``flash_attention``), wrapper (``ops``)."""
