"""step_mfu.tok: model FLOPs of the work the traced stretch did, over its
seconds times the bf16 dense peak (989 TFLOP/s), in percent."""

from portbench.lib import metric_util as u


def read(ctx):
    return u.step_mfu(ctx)
