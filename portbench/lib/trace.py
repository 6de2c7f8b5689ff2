"""The device trace of a `--trace 1` run: torch.profiler over a stretch of
the window, read raw from kineto's results.

The host's operators are recorded beside the device's (without them a
session on an H100 dropped kernel records), and the results are read raw:
building every host operator's event first (`key_averages`) takes seconds
a thousand kernels. A range named `portbench.window` marks the traced
stretch; ranges named `portbench.<kind>#<n>` (serve.CallLog) mark the
engine calls. A device operation belongs to the call whose range holds the
host's launch of it: the runtime call with the operation's correlation id,
or else the host operator it is linked to.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

from portbench.lib import stats

_RANGE = re.compile(r"^portbench\.([a-z_]+)#(\d+)$")
WINDOW = "portbench.window"


@dataclass
class DeviceOp:
    name: str
    start: int     # ns, the trace's clock
    end: int
    call: int | None = None  # CallLog index of the launching call


@dataclass
class Trace:
    window: tuple[int, int]
    ops: list[DeviceOp]
    # CallLog index -> (kind, host start ns, host end ns)
    ranges: dict[int, tuple[str, int, int]] = field(default_factory=dict)
    gaps: list[tuple[float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return stats.union_length([(o.start, o.end) for o in self.ops],
                                  *self.window) / 1e9

    def top_ops(self, n: int = 10) -> list[list]:
        lo, hi = self.window
        by: dict[str, float] = {}
        for o in self.ops:
            s, e = max(o.start, lo), min(o.end, hi)
            if e > s:
                by[o.name] = by.get(o.name, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read(prof, n_gaps: int = 10) -> Trace:
    """A Trace from a stopped torch.profiler.profile."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    device, host = [], []
    for ev in results.events():
        if ev.device_type() == DeviceType.CUDA:
            # A record_function range is mirrored on the device's timeline
            # as an annotation spanning its kernels: not an operation.
            if not (ev.is_user_annotation()
                    or ev.name().startswith("portbench.")):
                device.append(ev)
        else:
            host.append(ev)
    window = None
    ranges: dict[int, tuple[str, int, int]] = {}
    launch_at: dict[int, int] = {}
    op_at: dict[int, int] = {}
    threads: dict[int, int] = {}
    for ev in host:
        name = ev.name()
        if name == WINDOW:
            window = (ev.start_ns(), ev.end_ns())
            continue
        m = _RANGE.match(name)
        if m:
            ranges[int(m.group(2))] = (m.group(1), ev.start_ns(),
                                       ev.end_ns())
            tid = ev.start_thread_id()
            threads[tid] = threads.get(tid, 0) + 1
            continue
        if name.startswith("cu"):
            launch_at.setdefault(ev.correlation_id(), ev.start_ns())
        else:
            op_at.setdefault(ev.correlation_id(), ev.start_ns())
    if window is None:
        raise RuntimeError("the trace holds no portbench.window range")
    starts = sorted((r[1], r[2], i) for i, r in ranges.items())
    keys = [s[0] for s in starts]

    def owner(t: int | None) -> int | None:
        if t is None:
            return None
        j = bisect.bisect_right(keys, t) - 1
        if j >= 0 and starts[j][1] >= t:
            return starts[j][2]
        return None

    ops = []
    for ev in device:
        t = launch_at.get(ev.correlation_id())
        if t is None:
            t = op_at.get(ev.linked_correlation_id())
        ops.append(DeviceOp(ev.name(), ev.start_ns(), ev.end_ns(), owner(t)))
    trace = Trace(window=window, ops=ops, ranges=ranges)
    trace.gaps = _label_gaps(trace, host, threads, n_gaps)
    return trace


def _label_gaps(trace: Trace, host, threads: dict[int, int], n: int
                ) -> list[tuple[float, str]]:
    """The n longest device-idle stretches of the window, each named by
    what the engine thread was doing when it began: the engine call whose
    range holds that moment, and the innermost host operator there."""
    idle = sorted(stats.gaps([(o.start, o.end) for o in trace.ops],
                             *trace.window),
                  key=lambda g: g[0] - g[1])[:n]
    engine_tid = max(threads, key=threads.get) if threads else None
    spans = sorted((ev.start_ns(), ev.end_ns(), ev.name()) for ev in host
                   if engine_tid is None
                   or ev.start_thread_id() == engine_tid)
    keys = [s[0] for s in spans]
    out = []
    for g0, g1 in idle:
        call = next((r[0] for r in trace.ranges.values()
                     if r[1] <= g0 <= r[2]), "outside the engine calls")
        j = bisect.bisect_right(keys, g0) - 1
        best = None
        for j in range(j, max(-1, j - 5000), -1):
            s, e, name = spans[j]
            if (e >= g0 and name != WINDOW and not _RANGE.match(name)
                    and (best is None or e - s < best[1] - best[0])):
                best = (s, e, name)
        what = call if best is None else f"{call}: {best[2]}"
        out.append(((g1 - g0) / 1e9, what))
    return out
