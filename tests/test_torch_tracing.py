"""The port's spans and counters (``utils/profiling.py::annotate`` and the
``beam_search_batched`` counters), on tiny models on the CPU.

* With no profiler recording, a span dispatches no profiler op.
* Under ``torch.profiler`` each layer boundary opens its span as often as
  the work says: one prefill, one ``beam.step`` and ``beam.rank`` per
  decode step, the GPT-2 blocks and LM head inside each step, one stop
  check per loop iteration, three phases per train step.
* The counters agree with the spans, and tracing changes no number.
* ``ONCE`` records each span's first call, once, with the section it
  began in; later calls leave it as it is; the benchmark's ``setup.*``
  metrics read it.
"""
import collections
import time
import types

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
from clipcap_tpu_torch.utils import profiling
from clipcap_tpu_torch.utils.profiling import ONCE, Timer, annotate, reset_once

from portbench import harness

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
    bp = BeamParams(beam_size=3, max_new_tokens=5, stop_token=NEVER)
    beam_search_batched(lm, prefix, bp, dtype=torch.float32)
    state, tx = _train_state()
    train_step(state, *_train_batch(), tx=tx, dtype=torch.float32)
    timer = Timer()
    with timer.section("encode"):
        pass
    # Seen names: the shared no-op context, and the record stays as it is.
    record = (dict(ONCE.totals), dict(ONCE.counts))
    for name in ("beam.step", "beam.prefill", "train.forward", "gpt2.blocks"):
        assert annotate(name) is profiling._OFF, name
    beam_search_batched(lm, prefix, bp, dtype=torch.float32)
    train_step(state, *_train_batch(), tx=tx, dtype=torch.float32)
    assert (dict(ONCE.totals), dict(ONCE.counts)) == record


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


# ---------------------------------------------------------------------------
# ONCE: the process's record of one-time work
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_once():
    """An empty record and no span seen, before and after the test."""
    reset_once()
    yield ONCE
    reset_once()


def _outermost(once) -> dict:
    return {n: s for n, s in once.totals.items()
            if n.startswith("first.") and once.parents[n] is None}


def test_first_call_recorded_once_with_its_parent(fresh_once):
    for _ in range(3):
        with annotate("t.outer"):
            with annotate("t.inner"):
                time.sleep(0.01)
            with annotate("t.sibling"):
                pass
    once = fresh_once
    assert once.counts == {"first.t.outer": 1, "first.t.inner": 1, "first.t.sibling": 1}
    assert once.parents == {"first.t.outer": None, "first.t.inner": "first.t.outer",
                            "first.t.sibling": "first.t.outer"}
    inner = once.totals["first.t.inner"] + once.totals["first.t.sibling"]
    assert once.totals["first.t.inner"] >= 0.01
    assert once.self_seconds("first.t.outer") == pytest.approx(
        once.totals["first.t.outer"] - inner)
    assert 0 <= once.self_seconds("first.t.outer") < once.totals["first.t.outer"]
    assert once.self_seconds("first.t.inner") == once.totals["first.t.inner"]


def test_first_call_keeps_its_span_under_the_profiler(fresh_once):
    """A first call opens its own span on the timeline, and no second."""
    with profile() as prof:
        with annotate("t.first"):
            pass
        with annotate("t.first"):
            pass
    spans = _spans(prof)
    assert len(spans["t.first"]) == 2
    assert not any(n.startswith("first.") for n in spans)
    assert fresh_once.counts == {"first.t.first": 1}


def test_once_sections_nest_under_a_first_call(fresh_once):
    with annotate("t.unit"):
        with ONCE.section("t.load"):
            with ONCE.section("t.build"):
                pass
        with ONCE.section("t.load"):
            pass
    once = fresh_once
    assert once.counts == {"first.t.unit": 1, "t.load": 2, "t.build": 1}
    assert once.parents == {"first.t.unit": None, "t.load": "first.t.unit",
                            "t.build": "t.load"}
    assert once.inner["first.t.unit"] == pytest.approx(once.totals["t.load"])
    assert _outermost(once) == {"first.t.unit": once.totals["first.t.unit"]}


def test_reset_clears_the_record_and_the_seen_names(fresh_once):
    with annotate("t.reset"):
        pass
    with ONCE.section("t.section"):
        pass
    assert ONCE.counts and "t.reset" in profiling._SEEN
    reset_once()
    assert (ONCE.totals, ONCE.counts, ONCE.parents, ONCE.inner) == ({}, {}, {}, {})
    assert "t.reset" not in profiling._SEEN
    with annotate("t.reset"):          # first again
        pass
    assert ONCE.counts == {"first.t.reset": 1}


def test_beam_search_records_its_first_calls(fresh_once, lm, prefix):
    bp = BeamParams(beam_size=3, max_new_tokens=5, stop_token=NEVER)
    t0 = time.perf_counter()
    beam_search_batched(lm, prefix, bp, dtype=torch.float32)
    wall = time.perf_counter() - t0
    once = fresh_once
    top = _outermost(once)
    assert set(top) == {"first.beam.prefill", "first.beam.stop_check", "first.beam.step"}
    assert once.parents["first.beam.rank"] == "first.beam.step"
    assert once.parents["first.gpt2.blocks"] == "first.beam.prefill"
    assert once.parents["first.gpt2.lm_head"] == "first.beam.prefill"
    assert all(c == 1 for c in once.counts.values())
    assert "graphs.capture" not in once.counts          # the CPU captures nothing
    assert 0 < sum(top.values()) <= wall


def test_train_step_records_its_first_calls(fresh_once):
    state, tx = _train_state()
    batch = _train_batch()
    t0 = time.perf_counter()
    train_step(state, *batch, tx=tx, dtype=torch.float32)
    wall = time.perf_counter() - t0
    once = fresh_once
    top = _outermost(once)
    assert set(top) == {"first.train.forward", "first.train.backward",
                        "first.train.optimizer"}
    assert once.parents["first.gpt2.lm_head"] == "first.train.forward"
    assert 0 < sum(top.values()) <= wall
    train_step(state, *batch, tx=tx, dtype=torch.float32)
    assert _outermost(once) == top


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel library and CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_library_load_is_recorded(cuda, fresh_once):
    from clipcap_tpu_torch.ops import _build

    _build.load_library()                     # built, if this checkout has no library
    _build.load_library.cache_clear()
    reset_once()
    _build.load_library()
    assert ONCE.counts == {"kernels.load": 1}  # the library exists: no build
    assert ONCE.parents["kernels.load"] is None
    _build.load_library()                     # cached: nothing more
    assert ONCE.counts == {"kernels.load": 1}


@pytest.mark.cuda
def test_graph_capture_is_recorded_per_segment(cuda, fresh_once):
    card = GPT2Config(vocab_size=1000, n_positions=128, n_embd=128, n_layer=3, n_head=2,
                      name="card")
    lm = gpt2_from_params(init_gpt2(card, seed=5), card).to(cuda, torch.bfloat16)
    pre = torch.randn(3, 4, 128, generator=torch.Generator(device=cuda).manual_seed(7),
                      device=cuda)
    bp = BeamParams(beam_size=5, max_new_tokens=8, stop_token=NEVER)
    beam_search_batched(lm, pre, bp)
    assert ONCE.counts["graphs.capture"] == lm.decode_segments
    assert ONCE.parents["graphs.capture"] == "first.beam.step"
    assert ONCE.inner["first.beam.step"] >= ONCE.totals["graphs.capture"]
    beam_search_batched(lm, pre, bp)          # the same key: replays only
    assert ONCE.counts["graphs.capture"] == lm.decode_segments


# ---------------------------------------------------------------------------
# The benchmark's setup.* metrics (portbench/metrics/setup.*.py)
# ---------------------------------------------------------------------------

SETUP_METRICS = {"setup.first_calls_s": "all", "setup.graph_capture_s": "caption",
                 "setup.kernel_library_s": "all"}


def _hand_filled() -> Timer:
    t = Timer()
    t.totals = {"first.beam.prefill": 2.0, "first.beam.step": 3.0, "first.gpt2.blocks": 1.5,
                "kernels.load": 0.25, "kernels.build": 0.2, "graphs.capture": 1.25}
    t.counts = {"first.beam.prefill": 1, "first.beam.step": 1, "first.gpt2.blocks": 1,
                "kernels.load": 1, "kernels.build": 1, "graphs.capture": 13}
    t.parents = {"first.beam.prefill": None, "first.beam.step": None,
                 "first.gpt2.blocks": "first.beam.prefill", "kernels.load": "first.gpt2.blocks",
                 "kernels.build": "kernels.load", "graphs.capture": "first.beam.step"}
    t.inner = {"first.beam.prefill": 1.5, "first.gpt2.blocks": 0.25, "kernels.load": 0.2,
               "first.beam.step": 1.25}
    return t


def _ctx(kind):
    return types.SimpleNamespace(work={"kind": kind, "units": 1})


@pytest.mark.parametrize("kind", ["caption", "embed", "train"])
@pytest.mark.parametrize("name", sorted(SETUP_METRICS))
def test_setup_metric_reads_the_record(name, kind, monkeypatch, capsys):
    monkeypatch.setattr(profiling, "ONCE", _hand_filled())
    want = {"setup.first_calls_s": 5.0, "setup.graph_capture_s": 1.25,
            "setup.kernel_library_s": 0.25}[name]
    applies = SETUP_METRICS[name] in ("all", kind)
    assert harness.metric_module(name).read(_ctx(kind)) == (want if applies else None)
    if name == "setup.first_calls_s":
        line = capsys.readouterr().err.strip()
        assert line.startswith("once: first.beam.step x1 3.000 s (self 1.750); ")
        assert "graphs.capture x13 1.250 s (self 1.250)" in line
        assert line.count(" x") == 6


@pytest.mark.parametrize("name", sorted(SETUP_METRICS))
def test_setup_metric_reads_nothing_without_the_record(name, monkeypatch):
    """A program without ``ONCE`` (as before it was added), or whose record
    lacks the section: no reading, no error."""
    monkeypatch.setattr(profiling, "ONCE", Timer())
    assert harness.metric_module(name).read(_ctx("caption")) is None
    monkeypatch.delattr(profiling, "ONCE")
    assert harness.metric_module(name).read(_ctx("caption")) is None


@pytest.mark.parametrize("name", sorted(SETUP_METRICS))
def test_setup_metric_matches_its_benchmark_entry(name):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    mod = harness.metric_module(name)
    assert mod.LAYER == entry["layer"] == "set-up"
    assert mod.MOVES == entry["moves"] == "setup_s"
    assert (entry["unit"], entry["better"], entry["source"]) == ("s", "lower",
                                                               "program_counter")
    cells = [w["name"] for w in bench["workloads"]
             if SETUP_METRICS[name] == "all" or w["name"].startswith("caption.")]
    assert entry["workloads"] == cells
