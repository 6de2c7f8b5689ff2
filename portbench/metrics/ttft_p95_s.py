"""ttft_p95_s: the 95th percentile of time to first token over every
request sent in the window, timed from the send. Requests still waiting at
the close were drained; one that never got a token (failed, or still
waiting when the drain gave up) counts as missing every limit."""

from portbench.lib import stats


def read(ctx):
    reqs = ctx.window_requests()
    if not reqs:
        return None
    ttft = [r.first - r.sent if r.first is not None else float("inf")
            for r in reqs]
    return stats.percentile(ttft, 95)
