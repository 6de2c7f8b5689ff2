"""w8a16_gemv_roofline.tok: the W8A16 GEMV's share of its roofline over the
decode steps of the traced stretch, in percent. Each step runs every
layer's attention projections and the LM head, int8, on every slot's row
(work.w8a16_product); the time is the device time of the GEMV kernels
those calls launched."""

from portbench.lib import metric_util as u
from portbench.lib import work


def read(ctx):
    d = ctx.dims
    calls = u.complete_calls(ctx, "decode")
    t = u.device_s(ctx, calls, ("w8a16_gemv",))
    if not calls or t <= 0:
        return None
    m = int(ctx.deployment.get("max_batch_size", 8))
    leaves = ([(d.hidden, d.q_dim), (d.hidden, d.kv_dim),
               (d.hidden, d.kv_dim), (d.q_dim, d.hidden)] * d.layers
              + [(d.hidden, d.vocab)])
    flops = nbytes = 0.0
    for i in calls:
        steps = ctx.calls_by_index[i].meta["steps"]
        for k, n in leaves:
            f, b = work.w8a16_product(m, k, n, u.act_bytes(ctx))
            flops += steps * f
            nbytes += steps * b
    return 100.0 * work.least_seconds(flops, nbytes,
                                      work.PEAK_BF16_FLOPS) / t
