"""chunk_busy_ms.ttft: device milliseconds of the operations launched
inside the chunked-prefill calls of the traced stretch, per chunk."""

from portbench.lib import metric_util as u


def read(ctx):
    return u.busy_ms_per(ctx, "chunk", steps=False)
