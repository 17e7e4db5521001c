"""cednerf_torch — the PyTorch / CUDA port of cednerf_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (engine/config.py, ops/brick_grid.py,
models/field.py, engine/renderer.py, viewer/server.py, ...). Plain tensor
code is PyTorch; every TPU kernel on a ported path is a hand-written CUDA
kernel under csrc/, built with nvcc at first use and bound through ctypes
(ops/encode_kernels.py). This slice serves renders: the D-NeRF field's
forward, the occupancy grid, the segment-compacted eval renderer and the web
viewer. Training comes with a later slice.

The package imports torch and numpy only, never jax, flax or cednerf_tpu.
Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
