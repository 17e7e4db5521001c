"""nerfbench: the benchmark of cednerf_torch (see README.md)."""
