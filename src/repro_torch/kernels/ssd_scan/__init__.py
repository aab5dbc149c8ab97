"""Mamba-2 SSD intra-chunk block: plain version (``ref``), CUDA kernel and binding (``csrc``, ``ssd_scan``), wrapper (``ops``)."""
