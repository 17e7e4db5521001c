"""mfu.serve: the field's MLP operations over the unprofiled stretch
against the card's bfloat16 peak, in percent: every row a frame's passes
hand the field, through its density and colour paths."""

from nerfbench.counts import flops, peaks


def read(ctx):
    rows = ctx.counters["rows"]
    if not rows:
        return None
    total = sum(n * flops.row_flops(ctx.config, kind)
                for kind, n in rows.items())
    pk = peaks.peaks(ctx.device_kind)
    return total / (ctx.spans["stretch_s"] * pk["bf16_flops"]) * 100.0
