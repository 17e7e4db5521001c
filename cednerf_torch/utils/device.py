"""Device selection for the port's entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points default to CUDA and refuse to fall back to the CPU.

    Only a caller that asks for device="cpu" (the tests) runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cednerf_torch: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
