"""Beam decode steps split into dense segments, and their CUDA graphs.

A beam decode step of ``models/gpt2.py`` runs its blocks as L + 1 dense
segments split at each layer's decode attention
(``_beam_decode_blocks``); on the card the segments replay CUDA graphs
(``models/decoding.py::StepGraphs``).

* On the CPU the segmented step is held to ``_unsplit_step``, a plain copy
  of the unsplit beam decode branch of ``_cached_block`` that it replaced:
  logits and caches bit-identical in the strided, tile-major, int8 and
  consolidated (C > 0) forms.  No graph is taken there, and the keys of a
  model's graphs are bounded and dropped with the weights they read.
* The tests marked ``cuda`` hold graphed beam search on the card to the
  same segments run eagerly (``decode_step_graphs`` patched to give none):
  tokens, lengths and scores bit-identical, in every cache form, with
  int8 weights, at two batch sizes and after the weights are replaced.
"""
import copy
import math

import pytest
import torch

from clipcap_tpu_torch.convert import gpt2_from_params
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import decoding, gpt2
from clipcap_tpu_torch.models.gpt2 import (GPT2_PRESETS, GPT2Config, gpt2_apply,
                                           gpt2_embed_tokens, init_gpt2, init_kv_cache,
                                           init_shared_kv)
from clipcap_tpu_torch.ops.flash_decode import flash_decode_two_phase
from clipcap_tpu_torch.ops.quant import quantize_gpt2_int8
from clipcap_tpu_torch.utils.profiling import ONCE

NEVER = -1    # a stop token no step emits: the search runs to max_new_tokens
FORMS = ["strided", "tile_major", "int8_kv", "consolidated"]


# ---------------------------------------------------------------------------
# The unsplit beam decode step (the branch the segments replaced)
# ---------------------------------------------------------------------------


def _unsplit_block(x, layer, ckv, cache_index, cfg, K, ancestry, cache_base, shared,
                   shared_step):
    B, S, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    q, k, v = gpt2._split_qkv(layer.attn.c_attn(layer.ln_1(x)), cfg)
    R = B // K
    qg = q.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)   # [R, H, K, S, Dh]
    kg = k.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)
    vg = v.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)
    new_flat = torch.cat([kg, vg], -1).transpose(2, 3).reshape(R, H, S * K, 2 * Dh)
    live_index = cache_index - cache_base
    base_slot = 0 if shared is not None else cache_base
    gpt2._write_kv(ckv, new_flat, base_slot + live_index * K)
    q1 = qg[:, :, :, 0].contiguous()
    if shared is None:
        attn = gpt2._decode_attend(q1, ckv, ancestry, base_slot + (live_index + 1) * K)
    else:
        skv, s_scales = gpt2._split_cache(shared)
        lkv, l_scales = gpt2._split_cache(ckv)
        attn = flash_decode_two_phase(
            q1, skv, shared_step.mask, lkv, ancestry, sh_valid=shared_step.sh_valid,
            lv_lo=shared_step.lv_lo, lv_valid=(live_index + 1) * K,
            shared_scales=s_scales, live_scales=l_scales)
    attn_out = attn.transpose(1, 2).reshape(B, S, D)
    x = x + layer.attn.c_proj(attn_out)
    return gpt2._mlp(x, layer, cfg)


def _unsplit_step(model, emb, kv_cache, cache_index, K, ancestry, cache_base, shared_kv,
                  shared_len, dtype):
    """The beam decode step of ``gpt2_apply`` before the split → logits."""
    cfg = model.config
    x = emb.to(dtype) + model.wpe.weight[cache_index:cache_index + 1].to(dtype)[None]
    step = None
    if shared_kv is not None:
        step = gpt2._shared_step(shared_kv, shared_len, K, cache_base, x.device)
    mask = decoding.beam_mask(ancestry, K, gpt2._cache_slots(kv_cache[0]), cache_index,
                          cache_base, shared_len if shared_kv is not None else None)
    shared_layers = [None] * cfg.n_layer if step is None else shared_kv
    for layer, ckv, sh in zip(model.h, kv_cache, shared_layers):
        x = _unsplit_block(x, layer, ckv, cache_index, cfg, K, mask, cache_base, sh, step)
    return gpt2.lm_logits(model, model.ln_f(x))


@pytest.fixture(scope="module")
def lm():
    cfg = GPT2_PRESETS["gpt2-test"]
    return gpt2_from_params(init_gpt2(cfg, seed=4), cfg)


def _prefilled(lm, form, R, K, P, N, dtype, g):
    """A beam cache (and the shared one for the consolidated form) after the
    prefix's prefill, as ``beam_search_batched`` lays them out."""
    cfg = lm.config
    pe = torch.randn(R, P, cfg.n_embd, generator=g).to(dtype)
    int8 = form == "int8_kv"
    kw = dict(dtype=dtype, beam_size=K, int8=int8)
    if form == "consolidated":
        shared = init_shared_kv(cfg, R, P + N, dtype=dtype)
        gpt2_apply(lm, inputs_embeds=pe, kv_cache=shared, cache_index=0, dtype=dtype,
                   return_logits=False)
        return init_kv_cache(cfg, R * K, N, tile_major=False, **kw), shared
    cache = init_kv_cache(cfg, R * K, N, prefix_slots=P, tile_major=form == "tile_major", **kw)
    gpt2_apply(lm, inputs_embeds=pe, kv_cache=cache, cache_index=0, dtype=dtype,
               return_logits=False)
    return cache, None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", FORMS)
def test_segmented_step_matches_unsplit_step(lm, form, dtype):
    """Three decode steps over a random ancestry: the segmented step's logits
    and cache writes equal the unsplit step's bit for bit."""
    g = torch.Generator().manual_seed(FORMS.index(form))
    R, K, P, N = 2, 3, 5, 6
    B = R * K
    cache, shared = _prefilled(lm, form, R, K, P, N, dtype, g)
    twin_cache, twin_shared = copy.deepcopy((cache, shared))
    ancestry = torch.randint(0, K, (B, N), generator=g)
    for step in range(3):
        pos = P + step
        ancestry[:, step] = torch.arange(B) % K
        emb = gpt2_embed_tokens(lm, torch.randint(0, 50257, (B, 1), generator=g), dtype)
        # The consolidated form: the shared region ends at P, then per sample.
        c = P if step < 2 else torch.tensor([P, P + 1], dtype=torch.int32)
        kw = dict(shared_kv=shared, shared_len=c) if shared is not None else {}
        got, _ = gpt2_apply(lm, inputs_embeds=emb, kv_cache=cache, cache_index=pos,
                            dtype=dtype, beam_size=K, ancestry=ancestry.clone(),
                            cache_base=P, **kw)
        want = _unsplit_step(lm, emb, twin_cache, pos, K, ancestry.clone(), P, twin_shared,
                             c if shared is not None else None, dtype)
        assert got.dtype == want.dtype and torch.equal(got, want), f"step {step}"
        for a, b in zip(cache, twin_cache):
            for x, y in zip(*(t if isinstance(t, tuple) else (t,) for t in (a, b))):
                assert torch.equal(x, y), f"step {step}"


def test_no_graphs_on_the_cpu(lm):
    """A beam search on the CPU runs its segments eagerly: no graph is
    captured or replayed, and the search counts its steps as before."""
    assert decoding.decode_step_graphs(lm, 6, 3, torch.float32, "cpu") is None
    before = (beam_search_batched.graph_steps, _captured(), beam_search_batched.decode_steps)
    prefix = torch.randn(2, 4, lm.config.n_embd, generator=torch.Generator().manual_seed(1))
    beam_search_batched(lm, prefix, BeamParams(beam_size=3, max_new_tokens=5,
                                               stop_token=NEVER), dtype=torch.float32)
    assert (beam_search_batched.graph_steps, _captured()) == before[:2]
    assert beam_search_batched.decode_steps == before[2] + 4
    if not torch.cuda.is_available():       # else a search on the card may have run first
        assert before[:2] == (0, 0)


def test_graphs_leave_prefill_and_plain_decode_alone(lm):
    """Graphs serve beam decode steps only."""
    cache = init_kv_cache(lm.config, 2, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="beam decode steps only"):
        gpt2_apply(lm, input_ids=torch.zeros(2, 3, dtype=torch.long), kv_cache=cache,
                   graphs=decoding.StepGraphs(lm.config.n_layer + 1))


def test_graph_keys_are_bounded_and_follow_the_weights():
    """The few most recent keys are kept; a key comes back as the same
    graphs until a weight tensor is replaced; a copy of the model starts
    with none."""
    cfg = GPT2Config(vocab_size=64, n_positions=32, n_embd=16, n_layer=2, n_head=2, name="k")
    model = gpt2_from_params(init_gpt2(cfg, seed=0), cfg)
    graphs = model.decode_graphs
    dev = torch.device("cuda", 0)       # a key only: nothing runs on it here
    first = graphs.get(model, (10, 5, torch.bfloat16, dev))
    assert graphs.get(model, (10, 5, torch.bfloat16, dev)) is first
    assert first.segments == cfg.n_layer + 1 and not first.ready
    for rows in range(1, graphs.KEEP + 1):
        graphs.get(model, (rows, 5, torch.bfloat16, dev))
    assert graphs.get(model, (10, 5, torch.bfloat16, dev)) is not first    # evicted
    again = graphs.get(model, (10, 5, torch.bfloat16, dev))
    assert graphs.get(model, (10, 5, torch.bfloat16, dev)) is again
    model.load_state_dict(model.state_dict())             # copies into the same tensors
    assert graphs.get(model, (10, 5, torch.bfloat16, dev)) is again
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    fresh = graphs.get(model, (10, 5, torch.bfloat16, dev))
    assert fresh is not again and len(graphs._keys) == 1
    assert copy.deepcopy(model).decode_graphs._keys == {}


def test_graph_keys_follow_the_weight_storage():
    """Storage swapped under the same parameters drops every key: a cast of
    the weights, a CPU round trip's new tensors, one weight's ``.data``
    replaced.  A write into the weights in place keeps the keys."""
    cfg = GPT2Config(vocab_size=64, n_positions=32, n_embd=16, n_layer=2, n_head=2, name="k")
    model = gpt2_from_params(init_gpt2(cfg, seed=0), cfg)
    graphs = model.decode_graphs
    key = (10, 5, torch.bfloat16, torch.device("cuda", 0))   # a key only: nothing runs
    held = graphs.get(model, key)

    def kept():
        nonlocal held
        now = graphs.get(model, key)
        same, held = now is held, now
        return same

    with torch.no_grad():
        model.h[1].mlp.c_fc.weight.mul_(2.0)
    assert kept()
    model.to(torch.bfloat16)
    assert not kept()
    model.float()
    assert not kept()
    model.h[0].ln_1.weight.data = model.h[0].ln_1.weight.data.clone()
    assert not kept()
    model.ln_f.bias.data = model.ln_f.bias.data.clone()
    assert not kept()
    assert kept() and len(graphs._keys) == 1


# ---------------------------------------------------------------------------
# On the card: graphed beam search against the same segments run eagerly
# ---------------------------------------------------------------------------

# Head size 64, as the decode kernel takes it.
CARD_LM = GPT2Config(vocab_size=1000, n_positions=128, n_embd=128, n_layer=3, n_head=2,
                     name="card")


def _captured() -> int:
    """Decode segments captured in the process (``ONCE``'s ``graphs.capture``)."""
    return ONCE.counts.get("graphs.capture", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the decode kernels have no CPU mode")
    return torch.device("cuda")


def _card_lm(dev, seed=5, weights=torch.bfloat16):
    return gpt2_from_params(init_gpt2(CARD_LM, seed=seed), CARD_LM).to(dev, weights)


def _params(form, N=12):
    return BeamParams(beam_size=5, max_new_tokens=N, stop_token=NEVER,
                      int8_kv=form == "int8_kv",
                      consolidate_every=8 if form == "consolidated" else 0,
                      tile_major=form == "tile_major")


def _search(lm, prefix, bp, monkeypatch=None):
    """Beam search → (result, decode steps, graph steps, segments captured)
    counted over it; eager (no graphs) where ``monkeypatch`` is given."""
    if monkeypatch is not None:
        monkeypatch.setattr(beam_mod, "decode_step_graphs", lambda *a, **k: None)
    c = beam_search_batched
    before = (c.decode_steps, c.graph_steps, _captured())
    res = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if monkeypatch is not None:
        monkeypatch.undo()
    return res, *(now - was for now, was in zip((c.decode_steps, c.graph_steps,
                                                 _captured()), before))


def _assert_same(got, want):
    for name in ("tokens", "seq_lengths", "scores"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS + ["int8_weights"])
def test_graphed_beam_search_matches_eager_segments(cuda, form, monkeypatch):
    """Tokens, lengths and scores bit-identical to the eager segments; the
    first search of a key captures each segment once, every later step replays."""
    lm = _card_lm(cuda, weights=torch.float32 if form == "int8_weights" else torch.bfloat16)
    if form == "int8_weights":
        lm = quantize_gpt2_int8(lm)
    bp = _params("strided" if form == "int8_weights" else form)
    g = torch.Generator(device=cuda).manual_seed(7)
    prefix = torch.randn(3, 4, CARD_LM.n_embd, generator=g, device=cuda)
    want, steps, graphed, captured = _search(lm, prefix, bp, monkeypatch)
    assert (steps, graphed, captured) == (bp.max_new_tokens - 1, 0, 0)
    got, steps, graphed, captured = _search(lm, prefix, bp)
    _assert_same(got, want)
    assert (graphed, captured) == (steps - 1, lm.decode_segments)
    got, steps, graphed, captured = _search(lm, prefix, bp)
    _assert_same(got, want)
    assert (graphed, captured) == (steps, 0)


@pytest.mark.cuda
def test_two_batch_sizes_capture_a_key_each(cuda, monkeypatch):
    lm = _card_lm(cuda)
    bp = _params("strided")
    g = torch.Generator(device=cuda).manual_seed(8)
    big = torch.randn(3, 4, CARD_LM.n_embd, generator=g, device=cuda)
    small = big[:2].clone()
    eager = {n: _search(lm, p, bp, monkeypatch)[0] for n, p in (("big", big), ("small", small))}
    captures = 0
    for name, prefix in (("big", big), ("small", small), ("big", big), ("small", small)):
        got, steps, graphed, captured = _search(lm, prefix, bp)
        _assert_same(got, eager[name])
        captures += captured
        assert graphed == steps - (captured > 0)
    assert captures == 2 * lm.decode_segments


@pytest.mark.cuda
def test_replaced_weights_are_captured_again(cuda, monkeypatch):
    """After ``load_state_dict(assign=True)`` puts new tensors in place, the
    next search captures again and follows the new weights."""
    lm = _card_lm(cuda)
    bp = _params("strided")
    g = torch.Generator(device=cuda).manual_seed(9)
    prefix = torch.randn(3, 4, CARD_LM.n_embd, generator=g, device=cuda)
    before = _search(lm, prefix, bp)[0]
    new = {k: (v * 1.5 if k.startswith("h.") and v.dim() == 2 else v.clone())
           for k, v in lm.state_dict().items()}
    lm.load_state_dict(new, assign=True)
    want = _search(lm, prefix, bp, monkeypatch)[0]
    got, steps, graphed, captured = _search(lm, prefix, bp)
    _assert_same(got, want)
    assert (graphed, captured) == (steps - 1, lm.decode_segments)
    assert not torch.equal(got.scores, before.scores)
    assert math.isfinite(float(got.scores.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["cast", "round_trip"])
def test_weights_moved_under_the_same_parameters_are_captured_again(cuda, move, monkeypatch):
    """``lm.to(another dtype)`` and ``.cpu()`` then ``.cuda()`` keep the
    parameter objects and swap their storage: the next search captures
    again and equals the eager segments over the moved weights."""
    lm = _card_lm(cuda)
    bp = _params("strided")
    g = torch.Generator(device=cuda).manual_seed(10)
    prefix = torch.randn(3, 4, CARD_LM.n_embd, generator=g, device=cuda)
    _search(lm, prefix, bp)                                   # captures
    params = list(lm.parameters())
    if move == "cast":
        lm.to(torch.float32)
    else:
        lm.cpu()
        # Take the freed blocks, so the weights come back at other addresses.
        held = [torch.empty(p.shape, dtype=p.dtype, device=cuda) for p in params]
        lm.cuda()
        del held
    assert all(a is b for a, b in zip(lm.parameters(), params))   # the same objects
    want = _search(lm, prefix, bp, monkeypatch)[0]
    got, steps, graphed, captured = _search(lm, prefix, bp)
    _assert_same(got, want)
    assert (graphed, captured) == (steps - 1, lm.decode_segments)
