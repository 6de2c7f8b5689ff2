"""launches_per_decode_step.ttft: kernels the device ran for the
decode-block calls of the traced stretch, per decode step."""

from portbench.lib import metric_util as u


def read(ctx):
    calls = u.complete_calls(ctx, "decode")
    if not calls:
        return None
    steps = sum(ctx.calls_by_index[i].meta["steps"] for i in calls)
    n = sum(1 for o in ctx.trace.ops if o.call in set(calls)
            and u.is_kernel(o.name))
    return n / steps
