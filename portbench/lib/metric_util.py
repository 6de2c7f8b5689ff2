"""Helpers the per-layer metric readers share."""

from __future__ import annotations

from portbench.lib import stats, work

_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def is_kernel(name: str) -> bool:
    return not any(w in name for w in _NOT_KERNELS)


def act_bytes(ctx) -> int:
    return 4 if ctx.deployment.get("dtype") == "float32" else 2


def complete_calls(ctx, kind: str) -> list[int]:
    """Calls of `kind` whose range lies wholly inside the traced stretch:
    every device operation they launched was recorded."""
    if ctx.trace is None:
        return []
    w0, w1 = ctx.trace.window
    return [i for i, (k, s, e) in ctx.trace.ranges.items()
            if k == kind and w0 <= s and e <= w1]


def device_s(ctx, calls: list[int], names: tuple[str, ...] = ()) -> float:
    """Device seconds of the operations these calls launched (only those
    whose name holds one of `names`, where given)."""
    want = set(calls)
    return sum(o.end - o.start for o in ctx.trace.ops if o.call in want
               and (not names or any(n in o.name for n in names))) / 1e9


def busy_ms_per(ctx, kind: str, steps: bool) -> float | None:
    calls = complete_calls(ctx, kind)
    if not calls:
        return None
    per = (sum(ctx.calls_by_index[i].meta["steps"] for i in calls)
           if steps else len(calls))
    return 1e3 * device_s(ctx, calls) / per


def idle_share(ctx) -> float | None:
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def window_flops(ctx, t0: float, t1: float) -> float:
    """Model FLOPs (work.token_flops) of the work done in [t0, t1) on the
    host clock: each decode token streamed then (its time as
    output_tok_s takes it), and each prefill, cached admission and chunk
    dispatched then, at its true lengths."""
    d = ctx.dims
    total = 0.0
    for r in ctx.records:
        times = stats.token_times(r.events)
        p = len(r.prompt)
        for k, t in enumerate(times):
            if k and t0 <= t < t1:
                total += work.token_flops(d, p + k - 1, logits=True)
    for c in ctx.calls:
        if not t0 <= c.start < t1:
            continue
        m = c.meta
        if c.kind == "prefill":
            total += sum(work.span_flops(d, 0, n, True) for n in m["lens"])
        elif c.kind == "cached":
            total += sum(work.span_flops(d, m["prefix"], n, True)
                         for n in m["lens"])
        elif c.kind == "chunk":
            total += work.span_flops(d, m["start"], m["start"] + m["tokens"],
                                     m["last"])
    return total


def step_mfu(ctx) -> float | None:
    if ctx.trace_host is None:
        return None
    t0, t1 = ctx.trace_host
    return 100.0 * window_flops(ctx, t0, t1) / (
        (t1 - t0) * work.PEAK_BF16_FLOPS)
