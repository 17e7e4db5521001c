"""passes_per_frame: passes of the segment eval renderer a frame, summed
over the frame's chunks (`ViewerServer.last_frame["passes_per_chunk"]`),
the mean over the unprofiled stretch's frames."""


def read(ctx):
    passes = ctx.counters.get("passes_per_frame")
    if not passes:
        return None
    return sum(passes) / len(passes)
