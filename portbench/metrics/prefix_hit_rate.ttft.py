"""prefix_hit_rate.ttft: admissions seeded from the prefix pool, as a share
of all pool lookups that admitted a request in the window (the pool's own
hits and misses)."""


def read(ctx):
    p0, p1 = ctx.pool
    if p0 is None or p1 is None:
        return None
    hits = p1["hits"] - p0["hits"]
    n = hits + p1["misses"] - p0["misses"]
    return 100.0 * hits / n if n else None
