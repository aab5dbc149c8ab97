"""RMSNorm: plain version (``ref``), Triton kernel (``rmsnorm``), wrapper (``ops``)."""
