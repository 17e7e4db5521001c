"""Segmented reductions and broadcasts over packed ray-major sample buffers
(port of cednerf_tpu/ops/segments.py).

The packed train path lays a batch's samples out as contiguous per-ray
segments [starts, starts+counts) of a fixed [budget] buffer. Both helpers
do their per-ray work with one cumsum plus [R]-sized boundary gathers (or
a delta scatter), whose autograd is cheap: a cumsum's backward is a
reversed cumsum.

Layout: a multi-channel [B, C] array is scanned as [C, B], along its
contiguous dim. PyTorch's dim-0 cumsum of [B, C] runs with only C-way
parallelism on the card (28 ms per [262144, 6] pass on an H100, found while
profiling the serving path); the transposed scan gives the same sums.

Both give the same bits on every run: a one-channel scan goes through
utils/math.py::fixed_cumsum, and segment_broadcast writes each slot's
difference once (no float scatter-add whose colliding adds land in another
order on every run).
"""

import torch

from ..utils.math import fixed_cumsum


def segment_sum(per_slot: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, budget: int) -> torch.Tensor:
    """Per-ray sums of a packed per-slot array: [B(,C)] -> [R(,C)].

    One zero-padded inclusive f32 cumsum + two boundary gathers. Slots
    between blocks carry zeros (callers zero invalid slots), so one global
    cumsum is exact for any number of compaction blocks. f32 accumulation:
    the running total reaches ~1e4, so boundary differences keep ~1e-3
    absolute accuracy, as in the JAX package."""
    squeeze = per_slot.dim() == 1
    x = per_slot[None] if squeeze else per_slot.t()              # [C, B]
    z = fixed_cumsum(x.float(), dim=1)
    zp = torch.cat([z.new_zeros(z.shape[0], 1), z], dim=1)       # [C, B+1]
    lo = zp[:, starts.long()]
    hi = zp[:, torch.clamp(starts + counts, max=budget).long()]
    out = hi - lo                                                # [C, R]
    return out[0] if squeeze else out.t()


def segment_broadcast(vals: torch.Tensor, starts: torch.Tensor, budget: int,
                      n_blocks: int = 1) -> torch.Tensor:
    """Broadcast per-ray rows to their packed slots: [R(,C)] -> [B(,C)].

    First differences of the rows are placed at the segment starts and
    integrated by a per-block cumsum: every slot at or after a ray's start
    (until the next start) carries that ray's row, including a block's
    invalid tail slots, which callers mask. Starts clamped to the end of
    their block land on a per-block spill slot that is cut off before the
    cumsum (JAX's layout, segments.py:67-76). starts are as _block_starts
    makes them, nondecreasing within each block, so rays that share a slot
    (rays with no samples share the next ray's start) are one run: JAX
    adds all of their differences there, which telescope to the run's last
    row minus the row before the run (0 at a block's start); here only the
    run's last ray writes that difference, the others write to slots of
    their own past the end, so every slot has one writer. Exact up to f32
    re-association of one block's telescoping sum."""
    squeeze = vals.dim() == 1
    v = vals[:, None] if squeeze else vals
    r, c = v.shape
    rb, bb = r // n_blocks, budget // n_blocks
    ray = torch.arange(r, device=v.device)
    blk = ray // rb
    local = torch.clamp(starts.long() - blk * bb, 0, bb)
    idx = blk * (bb + 1) + local                         # nondecreasing
    before = torch.searchsorted(idx, idx) - 1            # the ray before the run
    prev = torch.where((before >= blk * rb)[:, None],
                       v[torch.clamp(before, min=0)], torch.zeros_like(v))
    last = torch.ones_like(idx, dtype=torch.bool)
    last[:-1] = idx[1:] != idx[:-1]
    width = n_blocks * (bb + 1)
    dest = torch.where(last, idx, width + ray)
    buf = torch.zeros((c, width + r), dtype=v.dtype,
                      device=v.device).index_copy(1, dest, (v - prev).t())
    out = fixed_cumsum(buf[:, :width].reshape(c, n_blocks, bb + 1)[:, :, :bb],
                       dim=2)
    out = out.reshape(c, budget)
    return out[0] if squeeze else out.t()
