"""decode_block_ms.tok: host milliseconds inside the engine's decode-block
dispatch, per block, over the window's blocks. With the device the
bottleneck, the dispatch waits on the launch queue, so this follows the
block's device time; with the host the bottleneck, it is the launch cost."""


def read(ctx):
    calls = ctx.window_calls("decode")
    if not calls:
        return None
    return 1e3 * sum(c.end - c.start for c in calls) / len(calls)
