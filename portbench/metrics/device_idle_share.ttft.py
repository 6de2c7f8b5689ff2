"""device_idle_share.ttft: the share of the traced stretch in which no
operation ran on the device, in percent."""

from portbench.lib import metric_util as u


def read(ctx):
    return u.idle_share(ctx)
