"""Row-gather probe: K8 (row_gather) against torch.index_select. Port of
the JAX package's tools/profile_dma_gather.py.

    python -m cednerf_torch.tools.profile_row_gather [--rows 442368]
        [--n 1048576] [--widths 128,256] [--dtype bfloat16] [--iters 20]
        [--rows_in_flight 1,2,4,8,16] [--device cuda] [--seed 0]

For each width: a table [rows, W] drawn from the seed (normal values, cast
to the dtype) and N random indices in [0, rows); index_select's ms and M
rows/s, then for each rows-in-flight setting K8's ms, M rows/s and `match`:
the whole output equal to index_select's bit for bit. Times are CUDA events
over `iters` calls after one warm-up (CUDA only; on the CPU the plain
version runs and only `match` is reported).

Prints JSON lines: the card, then one line per width and per setting.
"""

import argparse
import json

import torch

from ..ops import gather_kernels as gk
from ..utils.bench import card_name, cuda_ms
from ..utils.device import resolve_device

_BITS = {2: torch.int16, 4: torch.int32}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bits."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(_BITS[a.element_size()]),
                            b.view(_BITS[b.element_size()])))


def run(rows=442368, n=1048576, widths=(128, 256), dtype="bfloat16",
        iters=20, rows_in_flight=gk.ROWS_IN_FLIGHT, device="cuda",
        seed=0) -> dict:
    dev = resolve_device(device)
    timed = dev.type == "cuda" and iters > 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, rows, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "rows": rows, "n": n, "dtype": dtype, "widths": []}
    for w in widths:
        table = torch.randn((rows, w), generator=gen, device=dev).to(
            getattr(torch, dtype))
        ref = table.index_select(0, idx)
        rec = {"w": w, "index_select_ms": None, "settings": []}
        if timed:
            rec["index_select_ms"] = cuda_ms(
                lambda: table.index_select(0, idx), iters)
            rec["index_select_mrows_per_s"] = n / rec["index_select_ms"] / 1e3
        for rif in rows_in_flight:
            got = gk.row_gather(table, idx, rif)
            s = {"rows_in_flight": rif, "match": bits_equal(got, ref),
                 "ms": None}
            del got
            if timed:
                s["ms"] = cuda_ms(lambda: gk.row_gather(table, idx, rif),
                                  iters)
                s["mrows_per_s"] = n / s["ms"] / 1e3
            rec["settings"].append(s)
        if timed:
            rec["fastest_rows_in_flight"] = min(
                rec["settings"], key=lambda s: s["ms"])["rows_in_flight"]
        res["widths"].append(rec)
        del table, ref
    res["all_match"] = all(s["match"] for rec in res["widths"]
                           for s in rec["settings"])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=442368,
                    help="table rows (default: one L8F4 fine cell table)")
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--widths", default="128,256")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rows_in_flight",
                    default=",".join(map(str, gk.ROWS_IN_FLIGHT)))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(card_name(), flush=True)
    res = run(args.rows, args.n, tuple(map(int, args.widths.split(","))),
              args.dtype, args.iters,
              tuple(map(int, args.rows_in_flight.split(","))), args.device,
              args.seed)
    for rec in res["widths"]:
        settings = rec.pop("settings")
        print(json.dumps({"index_select": rec, "rows": res["rows"],
                          "n": res["n"], "dtype": res["dtype"]}))
        for s in settings:
            print(json.dumps({"row_gather": s, "w": rec["w"]}))
    return 0 if res["all_match"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
