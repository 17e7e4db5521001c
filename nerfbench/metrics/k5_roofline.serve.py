"""k5_roofline.serve: the least time the card could take for the bytes and
operations that every call of K5, the brick encoder's forward
(`encode_kernels.fused_encode_fwd`) needs, over the device time of the
kernels launched inside those calls, in percent."""

from nerfbench.counts import bytes as nbytes
from nerfbench.counts import peaks

RANGE = "k5"


def read(ctx):
    if ctx.trace is None or RANGE not in ctx.entries:
        return None
    nbytes_, nflops = ctx.entries[RANGE]
    least = nbytes.least_seconds(nbytes_, nflops, peaks.peaks(ctx.device_kind))
    return least / ctx.trace.range_s(RANGE) * 100.0
