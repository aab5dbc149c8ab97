"""RMSNorm: plain version (``ref``), CUDA kernel and binding (``csrc``, ``rmsnorm``), wrapper (``ops``)."""
