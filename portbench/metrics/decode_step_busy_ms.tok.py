"""decode_step_busy_ms.tok: device milliseconds of the operations launched
inside the decode-block calls of the traced stretch, per decode step."""

from portbench.lib import metric_util as u


def read(ctx):
    return u.busy_ms_per(ctx, "decode", steps=True)
