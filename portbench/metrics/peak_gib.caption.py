"""Peak device memory over the profiled captioning batch, in GiB:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
(the weights, the tower's activations, the beam cache)."""
LAYER = "decode cache"
MOVES = "captions_per_s"


def read(ctx):
    if ctx.work["kind"] != "caption" or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
