"""Share of decode steps whose GPT-2 blocks replayed CUDA graphs, in %: the
program's counters ``beam_search_batched.graph_steps`` ÷
``beam_search_batched.decode_steps`` × 100 (``inference/beam.py``), over
every search of the process (the warm-up's capturing step included).  A
program without the graph counter reads nothing."""
LAYER = "decode loop"
MOVES = "captions_per_s"


def read(ctx):
    if ctx.work["kind"] != "caption":
        return None
    from clipcap_tpu_torch.inference import beam

    steps = getattr(beam.beam_search_batched, "decode_steps", 0)
    graphed = getattr(beam.beam_search_batched, "graph_steps", None)
    if not steps or graphed is None:
        return None
    return 100.0 * graphed / steps
