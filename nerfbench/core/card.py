"""The card a run uses: its name, count and power limit."""

import subprocess

import torch


def power_limit_w():
    """The first card's power limit by nvidia-smi, in watts (None where
    nvidia-smi does not answer)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device(count: int, memory_peak_bytes: int, **extra) -> dict:
    """The result line's `device` entry for `count` cards."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit_w": power_limit_w(), **extra}


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    """The process's peak of device memory (0 off the card)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def empty_cache(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
