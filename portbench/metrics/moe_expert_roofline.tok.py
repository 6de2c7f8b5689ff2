"""moe_expert_roofline.tok: the grouped int8 expert GEMV's share of its
roofline over the decode steps of the traced stretch, in percent. Each
step runs every layer's dense mixture on every slot's row: every expert's
`wg`, `wu` and `wd` (work.w8a16_product at the deployment's slots); the
time is the device time of the kernel's operations (`moe_gemv`) those calls
launched. None where the trace holds none of them, or the model has no
experts."""

from portbench.lib import metric_util as u
from portbench.lib import work


def read(ctx):
    d = ctx.dims
    calls = u.complete_calls(ctx, "decode")
    t = u.device_s(ctx, calls, ("moe_gemv",))
    if not calls or t <= 0 or not d.experts:
        return None
    m = int(ctx.deployment.get("max_batch_size", 8))
    steps = sum(ctx.calls_by_index[i].meta["steps"] for i in calls)
    flops = nbytes = 0.0
    for k, n in ((d.hidden, d.inter), (d.hidden, d.inter),
                 (d.inter, d.hidden)):
        f, b = work.w8a16_product(m, k, n, u.act_bytes(ctx))
        flops += steps * d.layers * d.experts * f
        nbytes += steps * d.layers * d.experts * b
    return 100.0 * work.least_seconds(flops, nbytes,
                                      work.PEAK_BF16_FLOPS) / t
