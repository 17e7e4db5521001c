"""cednerf_torch — the PyTorch / CUDA port of cednerf_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (engine/config.py, ops/brick_grid.py,
models/field.py, engine/renderer.py, engine/train.py, viewer/server.py,
...). Plain tensor code is PyTorch; every TPU kernel on a ported path is a
hand-written CUDA kernel under csrc/, built with nvcc at first use and bound
through ctypes (ops/cuda_build.py, ops/encode_kernels.py,
ops/compact_kernels.py); host C++ (the PNG unfilter, DyNeRF's ray sampler
and weight maps) is under csrc/host/, built with g++ (utils/host_build.py).
The port serves renders (the D-NeRF field, the occupancy grid, the
segment-compacted and lattice eval renderers, the web viewer) and trains
the field on the packed, budgeted train step (engine/train.py's Trainer),
over the procedural scenes of datasets/procedural.py or the D-NeRF,
HyperNeRF and DyNeRF loaders of datasets/ through the CLI
`python -m cednerf_torch.train_real`.

The package imports torch and numpy only, never jax, flax or cednerf_tpu.
Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
