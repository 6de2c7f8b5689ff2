"""flash_prefill_roofline.ttft: the flash prefill kernel's share of its
roofline over the whole-prompt prefills of the traced stretch, in percent:
the least time their attention needs (work.flash_prefill at each prompt's
true length, every layer) over the kernel's device time."""

from portbench.lib import metric_util as u
from portbench.lib import work


def read(ctx):
    d = ctx.dims
    calls = u.complete_calls(ctx, "prefill")
    t = u.device_s(ctx, calls, ("flash",))
    if not calls or t <= 0:
        return None
    flops = nbytes = 0.0
    for i in calls:
        f, b = work.flash_prefill(ctx.calls_by_index[i].meta["lens"],
                                  d.heads, d.kv_heads, d.head_dim,
                                  u.act_bytes(ctx))
        flops += d.layers * f
        nbytes += d.layers * b
    return 100.0 * work.least_seconds(flops, nbytes) / t
