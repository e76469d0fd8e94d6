"""Blocking device-to-host reads per decode step: the program's counters
``beam_search_batched.host_syncs`` ÷ ``beam_search_batched.decode_steps``
(``inference/beam.py``), over every search of the process."""
LAYER = "decode loop"
MOVES = "captions_per_s"


def read(ctx):
    if ctx.work["kind"] != "caption":
        return None
    from clipcap_tpu_torch.inference import beam

    steps = getattr(beam.beam_search_batched, "decode_steps", 0)
    syncs = getattr(beam.beam_search_batched, "host_syncs", None)
    if not steps or syncs is None:
        return None
    return syncs / steps
