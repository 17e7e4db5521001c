#!/usr/bin/env python3
"""Run one cell of cednerf_torch's benchmark once.

    python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's pieces are found by name (see
nerfbench/README.md). With --trace 0 the last line of standard output is
the cell's end-to-end metrics; with --trace 1 its per-layer metrics, read
from an unprofiled stretch of --seconds and a profiled one after it. Both
check the outputs of the timed path against the plain reference after the
window and print each number compared beside its limit, last on standard
error and last in the result line.

Exits non-zero, printing no result, when there is no CUDA card (or fewer
than the cell asks for), when a piece of the cell is missing, or when JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cednerf_tpu")


def _pin_caches():
    """Build and kernel caches in fixed directories of the checkout."""
    cache = HERE / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def _forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  .intersection(FORBIDDEN))


def _fail(msg: str, code: int = 2):
    print(f"nerfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def result_line(cell, out: dict, trace: bool, readers: dict) -> dict:
    """The result line of a driver's output: the cell's end-to-end metrics
    (trace False) or per-layer metrics from their readers (trace True),
    `correct` from the checks, which come last. A metric the cell must
    report and did not raises LookupError."""
    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(cell=cell,
                                    device_kind=out["device"]["kind"],
                                    **out["context"])
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is None:
                raise LookupError(f"per-layer metric {m['name']} found "
                                  f"nothing to read in {cell.name}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out["end_to_end"]:
                raise LookupError(f"end-to-end metric {m['name']} not "
                                  "measured")
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    checks = out["checks"]
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    from nerfbench.core import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA card (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present")
    readers = {m["name"]: spec.reader(m["name"]) for m in cell.per_layer}
    drv = spec.driver(cell)
    out = drv.run(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t_start=T_START)
    bad = _forbidden_loaded()
    if bad:
        _fail(f"modules loaded in the run: {bad}", 3)
    try:
        result = result_line(cell, out, bool(args.trace), readers)
    except LookupError as err:
        _fail(str(err), 4)
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
