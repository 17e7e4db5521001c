"""What the device did in a profiled stretch, read from torch.profiler.

`Profiled` runs a callable under the profiler (CPU and CUDA activities)
and keeps, from its events: the device's busy time (the union of kernel,
copy and memset intervals), the window's length by the host clock, device
time by kernel name, the idle gaps between device work labelled by the host
operation that launched the work after them, and the device time of every
range that `entry_range` opened.

`entry_range` wraps a module attribute (a function of the program that the
program looks up on the module at each call) in a named range and counts
what the caller of the range asks it to count, so that a reader can take
the device time of every kernel launched inside an entry point whatever
the kernels are called: a kernel belongs to the range in which the host
made the runtime call that launched it (the call and the kernel share an
id in the trace), so kernels launched through the program's own libraries
count as well as PyTorch's. The device-row filter is the one of the
program's profiling helpers, frozen here.
"""

import bisect
import collections
import contextlib
import time

import torch

RANGE_PREFIX = "nerfbench::"
TOP = 10


def _is_device_work(e) -> bool:
    """A kernel, copy or memset on the device timeline. Annotations on that
    timeline (ranges, "Optimizer.step#Adam.step", "ProfilerStep#1") span
    work already counted and are left out."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name
            and not e.name.startswith(RANGE_PREFIX)
            and e.time_range.end > e.time_range.start)


class Profiled:
    """Run fn() under torch.profiler, synchronised on both ends; the
    window is the host time between the two synchronisations."""

    def __init__(self, fn):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            self.result = fn()
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self._read(prof.events())

    def _read(self, events):
        cpu = torch.autograd.DeviceType.CPU
        dev = sorted((e for e in events if _is_device_work(e)),
                     key=lambda e: e.time_range.start)
        if not dev:
            raise RuntimeError("profiled stretch: no device work in the "
                               "trace")
        # each kernel, copy or memset shares its id with the runtime call
        # that launched it on the host, whoever made the call
        launch = {e.id: e for e in events
                  if e.device_type == cpu and e.name.startswith("cu")}
        ops = collections.defaultdict(list)       # thread -> host ops
        rngs = collections.defaultdict(list)      # thread -> ranges
        for e in events:
            if e.device_type == cpu and not e.name.startswith("cu"):
                iv = (e.time_range.start, e.time_range.end, e.name)
                ops[e.thread].append(iv)
                if e.name.startswith(RANGE_PREFIX):
                    rngs[e.thread].append(iv)
        index = {}
        for table in (ops, rngs):
            for v in table.values():
                v.sort()
            index[id(table)] = {t: [o[0] for o in v] for t, v in table.items()}

        def host_op(e, table):
            """The innermost interval of `table` (host ops or ranges) that
            was open when the host launched e."""
            call = launch.get(e.id)
            if call is None:
                return None
            t, th = call.time_range.start, call.thread
            seq = table.get(th, [])
            i = bisect.bisect_right(index[id(table)].get(th, []), t)
            for a, b, name in reversed(seq[max(0, i - 64):i]):
                if b >= t:
                    return name
            return None

        by_name = collections.Counter()
        gaps = collections.Counter()
        ranges = collections.Counter()
        busy = 0.0
        end = None
        for e in dev:
            a, b = e.time_range.start, e.time_range.end
            by_name[e.name] += (b - a) * 1e-6
            rng = host_op(e, rngs)
            if rng is not None:
                ranges[rng[len(RANGE_PREFIX):]] += (b - a) * 1e-6
            if end is None or a > end:
                if end is not None:
                    who = host_op(e, ops) or "unattributed"
                    gaps[f"before {who}"] += (a - end) * 1e-6
                busy += (b - a) * 1e-6
                end = b
            elif b > end:
                busy += (b - end) * 1e-6
                end = b
        self.busy_s = busy
        self.device_ops = [[k, v] for k, v in by_name.most_common(TOP)]
        self.idle_gaps = [[k, v] for k, v in gaps.most_common(TOP)]
        self.range_device_s = dict(ranges)
        self.range_calls = dict(collections.Counter(
            e.name[len(RANGE_PREFIX):] for e in events
            if e.device_type == cpu and e.name.startswith(RANGE_PREFIX)))

    def range_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside range `name`;
        raises where the range never opened or ran nothing on the device."""
        s = self.range_device_s.get(name, 0.0)
        if not s > 0.0:
            raise RuntimeError(
                f"profiled stretch: range {name!r} holds no device time "
                f"(opened {self.range_calls.get(name, 0)} times)")
        return s


@contextlib.contextmanager
def entry_range(module, attr: str, name: str, count=None, totals=None):
    """Inside the block, module.attr runs in the range `name`; with `count`,
    which gives (bytes, operations) of a call from its arguments and
    result, totals[name] sums them over the calls."""
    orig = getattr(module, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(RANGE_PREFIX + name):
            out = orig(*args, **kwargs)
        if count is not None:
            b, f = count(args, kwargs, out)
            was = totals.get(name, (0, 0))
            totals[name] = (was[0] + b, was[1] + f)
        return out

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, orig)
