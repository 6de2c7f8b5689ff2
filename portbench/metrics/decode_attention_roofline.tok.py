"""decode_attention_roofline.tok: the decode-attention launch's share of
its roofline over the decode steps of the traced stretch, in percent: the
least time (work.decode_attention over every lane at its cached length,
the step's row written, every layer) over the device time of the decode
kernels (the split and the combine)."""

from portbench.lib import metric_util as u
from portbench.lib import work


def read(ctx):
    d = ctx.dims
    calls = [i for i in u.complete_calls(ctx, "decode") if i in ctx.lengths]
    t = u.device_s(ctx, calls, ("decode_split", "decode_combine"))
    if not calls or t <= 0:
        return None
    cap = int(ctx.deployment.get("max_seq_len", 2048))
    int8 = ctx.deployment.get("kv_quantization") == "int8"
    flops = nbytes = 0.0
    for i in calls:
        lens = ctx.lengths[i]
        for step in range(ctx.calls_by_index[i].meta["steps"]):
            f, b = work.decode_attention(
                [min(n + step + 1, cap) for n in lens], d.heads, d.kv_heads,
                d.head_dim, kv_elem=1 if int8 else u.act_bytes(ctx),
                act_elem=u.act_bytes(ctx), scales=int8)
            flops += d.layers * f
            nbytes += d.layers * b
    return 100.0 * work.least_seconds(flops, nbytes) / t
