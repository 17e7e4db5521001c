"""Share of a frame in which no kernel, copy or memset ran on the card, in
percent: 1 - (device-busy seconds a profiled frame) / (wall seconds a frame
of the unprofiled stretch). The profiler stretches the host's side of a
frame but not the kernels, so the busy time comes from the trace and the
frame's length from the run without it."""


def read(ctx):
    tr, n = ctx.trace, ctx.counters.get("traced_frames")
    frames, wall = ctx.counters.get("frames"), ctx.spans.get("stretch_s")
    if tr is None or not (n and frames and wall) or not tr.busy_s > 0:
        return None
    return (1.0 - (tr.busy_s / n) / (wall / frames)) * 100.0
