"""`flash_attention`'s share of its roofline in the profiled slice: the least time
the card could take for the launches of the slice's blocks (bytes at HBM
bandwidth or FLOPs at the 3 x TF32 rate, whichever is larger, at valid
positions only) over the device time of the kernels of that name."""

from cnmt_bench.lib import costs


def read(run):
    w = run.window
    if w.slice is None or not w.slice_blocks:
        return None
    seconds = w.slice.seconds_matching("flash_attention")
    if seconds <= 0:
        return None
    bound = sum(costs.marian_block_bounds(b, run.widths)["flash_attention"]
                for b in w.slice_blocks)
    return 100.0 * bound / seconds
