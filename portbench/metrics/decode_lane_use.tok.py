"""decode_lane_use.tok: the share of the decode lane-steps dispatched in
the window that streamed a token, in percent. The scheduler's `tokens`
counter, less the first token of each request that got it in the window
(its prefill makes it), over its `steps` counter times the engine's slots,
both counters read at the window's open and close. A lane streams nothing
while it sits empty waiting for an admission, and on the steps of a block
past its request's finish.

`steps` counts a block at its dispatch and `tokens` at its sync, so a
window's edges can hold one block's steps without its tokens; over a
whole run the two counts match exactly."""


def read(ctx):
    c_open, c_close = ctx.counters
    steps = c_close["steps"] - c_open["steps"]
    decodes = [c for c in ctx.calls if c.kind == "decode"]
    if steps <= 0 or not decodes:
        return None
    firsts = sum(1 for r in ctx.records if r.first is not None
                 and ctx.t_open <= r.first < ctx.t_close)
    tokens = c_close["tokens"] - c_open["tokens"] - firsts
    return 100.0 * tokens / (steps * decodes[0].meta["slots"])
