"""Physical topologies: the fabric graph, TPU pods and the paper's a4 GPU testbed."""
