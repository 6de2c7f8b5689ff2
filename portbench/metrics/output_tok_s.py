"""output_tok_s: every token streamed in the window, over its seconds.

A token's time is its event's, the tokens of one event spread evenly back
to the stream's previous event (stats.token_times): a block's tokens were
made step by step between the two deliveries. Tokens of requests still
running at the close count."""

from portbench.lib import stats


def read(ctx):
    n = sum(stats.tokens_in(r.events, ctx.t_open, ctx.t_close)
            for r in ctx.records)
    return n / ctx.seconds
