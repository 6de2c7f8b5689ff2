"""admit_dispatch_ms.ttft: wall milliseconds per admission prefill dispatch
over the window, from the scheduler's own counters (admit_s over
admit_dispatches), not its bucketed histogram."""


def read(ctx):
    c0, c1 = ctx.counters
    n = c1["admit_dispatches"] - c0["admit_dispatches"]
    if n <= 0:
        return None
    return 1e3 * (c1["admit_s"] - c0["admit_s"]) / n
