"""Bytes and operations an encoder entry point needs for its inputs: each
input read once and each output written once, whatever the design reads
again, and the least time the card could take for them. A frozen copy of
the bound that the program's kernel checks state for the brick encoder's
forward; a kernel that splits or renames keeps this count.

Sizes: n samples, L levels, F features a level, R table rows of 64 F
values (the flat table of every level).
"""

CORNERS = 64   # corner lanes of a brick row, 4^3


def encode_fwd(n: int, L: int, F: int, R: int, table_bytes: int = 2,
               out_bytes: int = 2):
    """(bytes, flops) of the forward: positions [n, 3] f32 and level rows
    [L, n] int32 read, the table read once, features [n, L F] written; 8
    corners x F multiply-adds a (sample, level)."""
    b = n * 12 + L * n * 4 + R * CORNERS * F * table_bytes + n * L * F * out_bytes
    return b, n * L * 8 * F * 2


def least_seconds(nbytes: float, flops: float, pk: dict) -> float:
    """The larger of the bytes at the memory's rate and the operations at
    the f32 rate."""
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["f32_flops"])
