"""The port's spans and counters (``utils/profiling.py::annotate`` and the
``beam_search_batched`` counters), on tiny models on the CPU.

* With no profiler recording, a span dispatches no profiler op.
* Under ``torch.profiler`` each layer boundary opens its span as often as
  the work says: one prefill, one ``beam.step`` and ``beam.rank`` per
  decode step, the GPT-2 blocks and LM head inside each step, one stop
  check per loop iteration, three phases per train step.
* The counters agree with the spans, and tracing changes no number.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import profile

from clipcap_tpu_torch.config import Config, EncoderConfig
from clipcap_tpu_torch.convert import gpt2_from_params, mapper_from_params
from clipcap_tpu_torch.encoders.clip import CLIPEncoder
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models.clip_vit import load_clip
from clipcap_tpu_torch.models.clipcap import init_clipcap
from clipcap_tpu_torch.models.gpt2 import GPT2Config, init_gpt2
from clipcap_tpu_torch.models.mapper import MapperConfig, init_mapper, mapper_apply
from clipcap_tpu_torch.train.state import create_train_state, make_optimizer
from clipcap_tpu_torch.train.step import train_step
from clipcap_tpu_torch.utils.profiling import Timer, annotate

LM = GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4, name="tiny")
MAPPER = MapperConfig(encoder_embedding_size=16, lm_embedding_size=32, prefix_length=4,
                      projection_length=4, num_heads=4, num_layers=2)
NEVER = -1    # a stop token no step emits: the search runs to max_new_tokens


@pytest.fixture(scope="module")
def lm():
    return gpt2_from_params(init_gpt2(LM, seed=3), LM)


@pytest.fixture(scope="module")
def prefix():
    mapper = mapper_from_params(init_mapper(MAPPER, seed=4), MAPPER)
    emb = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32)
    return mapper_apply(mapper, emb)


def _train_state():
    config = Config(language_model="tiny", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=4,
                    encoder_config=EncoderConfig(encoder_embedding_size=16))
    model = init_clipcap(config, lm_config=LM, seed=6)
    tx = make_optimizer(1e-3, 1, 4)
    return create_train_state(model, tx), tx


def _train_batch():
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 128, size=(4, 9)))
    tokens[1, 5:] = -1
    return tokens, torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))


def _spans(prof) -> dict:
    """Each user span's host intervals, by name."""
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.is_user_annotation:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer) -> bool:
    return any(a <= s and e <= b for s, e in inner for a, b in outer)


def test_spans_dispatch_nothing_with_no_profiler(monkeypatch, lm, prefix):
    """Off, a span enters no ``record_function``: with the profiler op made
    to raise, beam search and a train step still run."""
    def raiser(*args, **kwargs):
        raise AssertionError("a span dispatched a profiler op with no profiler recording")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", raiser)
    with pytest.raises(AssertionError):          # the patch does catch a recording span
        with profile():
            with annotate("on"):
                pass
    beam_search_batched(lm, prefix, BeamParams(beam_size=3, max_new_tokens=5, stop_token=NEVER),
                        dtype=torch.float32)
    state, tx = _train_state()
    train_step(state, *_train_batch(), tx=tx, dtype=torch.float32)
    timer = Timer()
    with timer.section("encode"):
        pass


def test_beam_spans_and_counters_under_the_profiler(lm, prefix):
    bp = BeamParams(beam_size=3, max_new_tokens=6, stop_token=NEVER)
    steps0, syncs0 = beam_search_batched.decode_steps, beam_search_batched.host_syncs
    off = beam_search_batched(lm, prefix, bp, dtype=torch.float32)
    with profile() as prof:
        on = beam_search_batched(lm, prefix, bp, dtype=torch.float32)
    steps = beam_search_batched.decode_steps - steps0
    assert steps == 2 * (bp.max_new_tokens - 1)
    assert beam_search_batched.host_syncs - syncs0 == steps
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    spans = _spans(prof)
    n = steps // 2
    assert len(spans["beam.prefill"]) == 1
    assert len(spans["beam.step"]) == len(spans["beam.rank"]) == n
    assert len(spans["beam.stop_check"]) == n
    # One blocks loop and one LM-head product in each step, one more in the prefill.
    assert len(spans["gpt2.blocks"]) == len(spans["gpt2.lm_head"]) == n + 1
    for step in spans["beam.step"]:
        for name in ("beam.rank", "gpt2.blocks", "gpt2.lm_head"):
            assert _inside(spans[name], [step]), name
    assert _inside(spans["gpt2.blocks"], spans["beam.prefill"])
    assert not _inside(spans["beam.stop_check"], spans["beam.step"])


def test_host_syncs_count_the_stop_checks_of_an_early_stop(lm, prefix):
    """Greedy (K = 1) on one prefix, stopped on a token it emits at step j:
    j steps run a forward and j + 1 stop checks read the device."""
    free = beam_search_batched(lm, prefix[:1], BeamParams(beam_size=1, max_new_tokens=6,
                                                          stop_token=NEVER),
                               dtype=torch.float32).tokens[0, 0].tolist()
    j = max(i for i, t in enumerate(free[:-1]) if t not in free[:i])
    bp = BeamParams(beam_size=1, max_new_tokens=6, stop_token=free[j])
    steps0, syncs0 = beam_search_batched.decode_steps, beam_search_batched.host_syncs
    with profile() as prof:
        res = beam_search_batched(lm, prefix[:1], bp, dtype=torch.float32)
    assert res.tokens[0, 0, :j + 1].tolist() == free[:j + 1]
    steps = beam_search_batched.decode_steps - steps0
    assert steps == j
    assert beam_search_batched.host_syncs - syncs0 == steps + 1
    spans = _spans(prof)
    assert len(spans["beam.stop_check"]) == steps + 1
    assert len(spans["beam.step"]) == steps


def test_counters_survive_a_wrapper_bound_in_their_place(monkeypatch, lm, prefix):
    """A caller that rebinds ``beam.beam_search_batched`` (a wrapper around
    it) leaves the counters on the function that counts."""
    orig = beam_mod.beam_search_batched
    monkeypatch.setattr(beam_mod, "beam_search_batched", lambda *a, **k: orig(*a, **k))
    steps0 = orig.decode_steps
    beam_mod.beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=3,
                                                        stop_token=NEVER),
                                 dtype=torch.float32)
    assert orig.decode_steps - steps0 == 2


def test_train_step_spans_and_bit_identical_losses():
    batch = _train_batch()
    state_off, tx_off = _train_state()
    state_on, tx_on = _train_state()
    loss_off = train_step(state_off, *batch, tx=tx_off, dtype=torch.float32)
    with profile() as prof:
        loss_on = train_step(state_on, *batch, tx=tx_on, dtype=torch.float32)
    assert torch.equal(loss_off, loss_on)
    for (name, a), b in zip(state_off.model.named_parameters(), state_on.model.parameters()):
        assert torch.equal(a, b), name
    spans = _spans(prof)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert len(spans[name]) == 1, name
    assert _inside(spans["gpt2.lm_head"], spans["train.forward"])


def test_encoder_mapper_and_timer_spans():
    model, config = load_clip("test-tiny", device="cpu")
    encoder = CLIPEncoder(model, config, dtype=torch.float32)
    mapper = mapper_from_params(init_mapper(MAPPER, seed=4), MAPPER)
    images = np.random.default_rng(8).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    timer = Timer()
    off = encoder(images)
    with profile() as prof:
        with timer.section("encode"):
            on = encoder(images)
        mapper_apply(mapper, np.zeros((2, 16), np.float32))
    np.testing.assert_array_equal(off, on)
    spans = _spans(prof)
    for name in ("encoder.h2d", "encoder.tower", "encoder.d2h", "mapper", "encode"):
        assert len(spans[name]) == 1, name
    for name in ("encoder.h2d", "encoder.tower", "encoder.d2h"):
        assert _inside(spans[name], spans["encode"]), name
