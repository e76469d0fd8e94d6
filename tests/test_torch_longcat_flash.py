"""LongCat-Flash as the captioner's language model (``models/longcat_flash.py``).

At the tiny preset ``longcat-flash-test`` (hidden 64; 2 double layers,
each two latent attentions with a query LoRA of 24, 4 heads, a latent of
16, nope 16, rope 8, v 16; two dense SwiGLUs of 96; the shortcut MoE over
8 FFN experts of 32 + 4 identity experts, top-3, ×6; vocabulary 512;
seeded), on the CPU, in float32: the port against the benchmark's plain
reference (``portbench/reference/longcat_flash.py``), which runs each
sequence from position 0 with no cache, and the reference against the
installed ``transformers``' ``LongcatFlashForCausalLM``.  Tolerances: 2e-5
of the logits' scale for float32 against float32 (summation order only:
the absorbed decode, the grouped experts' twin and the cache against the
reference's decompressed attention and per-expert loop); 1e-4 against
``transformers`` (its RoPE rotates in the layout it reads, its router sums
experts in another order).

The tests marked ``cuda`` hold graphed beam search to the same segments
run eagerly at kernel-sized widths; this file imports no JAX, so on the
card: ``python -m pytest tests/test_torch_longcat_flash.py --noconftest -m
cuda -q``.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models import longcat_flash as lc
from clipcap_tpu_torch.models.deepseek_v2 import init_latent_cache
from clipcap_tpu_torch.models.longcat_flash import (LONGCAT_PRESETS, init_longcat,
                                                    longcat_apply, longcat_embed_tokens)
from clipcap_tpu_torch.ops import moe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import longcat_flash as ref  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402

CFG = LONGCAT_PRESETS["longcat-flash-test"]
NEVER = -1      # a stop token no step emits


def _ref_cfg(cfg) -> dict:
    """The reference's dict of config keys for a port config."""
    c = dataclasses.asdict(cfg)
    c["experts_held"] = list(cfg.experts_held)
    return c


@pytest.fixture(scope="module")
def lm():
    return init_longcat(CFG, seed=5)


def _ref_logits(lm, embeds):
    W = lm.state_dict()
    num = Numerics("fp32")
    return ref.lm_logits(W, ref.longcat_hidden(W, embeds, _ref_cfg(lm.config), num), num)


def _close(got, want, tol=2e-5):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, float((got - want).abs().max())


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("held", [(0, 8), (3, 6)], ids=["all_experts", "a_share"])
def test_forward_matches_reference(held):
    lm = init_longcat(dataclasses.replace(CFG, experts_held=held), seed=5)
    x = torch.randn(3, 9, CFG.hidden_size, generator=torch.Generator().manual_seed(0))
    logits, _ = longcat_apply(lm, inputs_embeds=x)
    _close(logits, _ref_logits(lm, x))


def test_cached_prefill_matches_the_uncached_forward(lm):
    """Writing the latents into the cache changes nothing: 2·L caches, the
    scaled latent and the roped ``k_pe`` a slot."""
    x = torch.randn(2, 7, CFG.hidden_size, generator=torch.Generator().manual_seed(3))
    cache = init_latent_cache(CFG, 2, 7, dtype=torch.float32)
    assert len(cache) == 2 * CFG.num_layers and cache[0].shape[-1] == 16 + 8
    got, _ = longcat_apply(lm, inputs_embeds=x, kv_cache=cache)
    want, _ = longcat_apply(lm, inputs_embeds=x)
    _close(got, want, tol=1e-6)
    assert float(cache[3][:, :7].abs().sum()) > 0


# -- prefill and beam decode through the latent cache ------------------------


def _beam_run(lm, g, reorders):
    """Prefill the folded prefix, then beam decode steps, the beams
    reordered by ``reorders[step]`` [R, K] after each step; yields each
    step's logits beside the reference's over each beam's own history."""
    R, K, P, N = 2, 3, 4, len(reorders) + 1
    B = R * K
    prefix = torch.randn(R, P, CFG.hidden_size, generator=g)
    cache = init_latent_cache(CFG, B, N, dtype=torch.float32, beam_size=K, prefix_slots=P)
    longcat_apply(lm, inputs_embeds=prefix, kv_cache=cache, cache_index=0, return_logits=False)
    own = torch.arange(B) % K
    ancestry = own[:, None].repeat(1, N)
    history = [[] for _ in range(B)]
    for step in range(1, N):
        pos = P + step - 1
        ancestry[:, pos - P] = own
        tok = torch.randint(0, CFG.vocab_size, (B,), generator=g)
        for b in range(B):
            history[b].append(int(tok[b]))
        logits, _ = longcat_apply(lm, inputs_embeds=longcat_embed_tokens(lm, tok[:, None]),
                                  kv_cache=cache, cache_index=pos, beam_size=K,
                                  ancestry=ancestry, cache_base=P)
        for b in range(B):
            x = torch.cat([prefix[b // K], longcat_embed_tokens(lm, torch.tensor(history[b]))])
            yield logits[b, 0], _ref_logits(lm, x[None])[0, -1]
        if step < N - 1:
            src = reorders[step - 1]
            ancestry = ancestry.reshape(R, K, N).gather(1, src[..., None].expand(R, K, N))
            ancestry = ancestry.reshape(B, N)
            history = [list(history[r * K + int(src[r, k])]) for r in range(R) for k in range(K)]


# Beams swap parents (sample 0 reversed, sample 1 rotated), then random draws.
SWAPS = [torch.tensor([[2, 1, 0], [1, 2, 0]]), torch.tensor([[0, 0, 2], [2, 2, 2]]),
         torch.tensor([[1, 2, 0], [0, 1, 1]])]


def test_prefill_then_beam_decode_matches_reference(lm):
    """Each step's logits (the absorbed latent attention over the folded
    beam cache, the shortcut carried across the second attention) equal the
    reference's full forward over the beam's own history."""
    for got, want in _beam_run(lm, torch.Generator().manual_seed(1), SWAPS):
        _close(got, want)


def _without_identity(orig):
    def _combine(y, offsets, inv, w, cfg, rows=None):
        return orig(y, offsets, inv, w, cfg, None if rows is None else torch.zeros_like(rows))
    return _combine


def _shortcut_after_the_first_mlp(orig):
    def _decode_segment(*args, **kwargs):
        return orig(*args, **dict(kwargs, shortcut=False))
    return _decode_segment


@pytest.mark.parametrize("attr,make", [("_combine", _without_identity),
                                       ("_decode_segment", _shortcut_after_the_first_mlp)],
                         ids=["identity_experts_left_out", "shortcut_after_the_first_mlp"])
def test_a_fault_fails_the_comparison(lm, monkeypatch, attr, make):
    """The identity experts' part left out, or the routed sum added with
    the first MLP instead of at the end of the double layer, gives other
    logits."""
    monkeypatch.setattr(dsv2, attr, make(getattr(dsv2, attr)))
    gaps = [_gap(got, want) for got, want in _beam_run(lm, torch.Generator().manual_seed(1),
                                                       SWAPS)]
    assert max(gaps) > 1e-2, max(gaps)


# -- the published code, routing and the expert share -------------------------


def _hf_config(transformers, **kw):
    return transformers.LongcatFlashConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        ffn_hidden_size=CFG.ffn_hidden_size, expert_ffn_hidden_size=CFG.expert_ffn_hidden_size,
        num_layers=CFG.num_layers, num_attention_heads=CFG.num_attention_heads,
        q_lora_rank=CFG.q_lora_rank, kv_lora_rank=CFG.kv_lora_rank,
        qk_nope_head_dim=CFG.qk_nope_head_dim, qk_rope_head_dim=CFG.qk_rope_head_dim,
        v_head_dim=CFG.v_head_dim, n_routed_experts=CFG.n_routed_experts,
        zero_expert_num=CFG.zero_expert_num, moe_topk=CFG.moe_topk,
        routed_scaling_factor=CFG.routed_scaling_factor, rms_norm_eps=CFG.rms_norm_eps,
        rope_theta=CFG.rope_theta, head_dim=CFG.qk_rope_head_dim, max_position_embeddings=512,
        **kw)


def test_port_and_reference_match_transformers(tmp_path):
    """``load_longcat`` over a checkpoint the installed library saves: the
    per-expert keys stacked, every expert held, the untied head; full-forward
    logits agree with ``LongcatFlashForCausalLM`` (a selection bias drawn so
    it moves picks).  A held share takes its slice of the experts."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "LongcatFlashForCausalLM"):
        pytest.skip("this transformers has no longcat_flash")
    torch.manual_seed(0)
    hf = transformers.LongcatFlashForCausalLM(
        _hf_config(transformers, attn_implementation="eager")).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for layer in hf.model.layers:
            bias = layer.mlp.router.e_score_correction_bias
            bias.copy_(torch.randn(bias.shape, generator=g) * 0.05)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    port = lc.load_longcat(str(tmp_path))
    assert port.config.experts_held == (0, CFG.n_routed_experts)
    assert port.config.num_hidden_layers == 2 * CFG.num_layers
    assert lc.is_longcat(str(tmp_path))
    x = torch.randn(2, 11, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = hf(inputs_embeds=x).logits
        got, _ = longcat_apply(port, inputs_embeds=x)
        reference = _ref_logits(port, x)
    _close(got, want, tol=1e-4)
    _close(reference, want, tol=1e-4)
    share = lc.load_longcat(str(tmp_path), experts_held=(2, 5))
    stacked = share.model.layers[1].mlp.experts.gate_up_proj     # expert 3 is local 1
    gate = hf.model.layers[1].mlp.experts[3].gate_proj.weight
    assert torch.equal(stacked[1, :CFG.expert_ffn_hidden_size], gate)


def test_router_picks_by_the_biased_softmax_and_weighs_by_the_unbiased():
    """Softmax over all FFN and identity experts, the top-k of score + bias,
    the unbiased scores × 6, not renormalised."""
    layer = init_longcat(CFG, seed=2).model.layers[0].mlp
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        layer.router.e_score_correction_bias.copy_(torch.randn(12, generator=g) * 0.05)
    h = torch.randn(7, CFG.hidden_size, generator=g)
    w, idx = dsv2._route(layer, h, CFG)
    scores = torch.softmax(h @ layer.router.classifier.weight.t(), dim=-1)
    want_idx = torch.topk(scores + layer.router.e_score_correction_bias, 3, dim=-1).indices
    assert torch.equal(idx, want_idx)
    assert bool((idx >= CFG.n_routed_experts).any())
    torch.testing.assert_close(w, scores.gather(-1, idx) * 6.0)


def _port_layer(cfg, W, x):
    """The port's double layer 0 of a one-layer model holding ``W``, the
    final norm left out."""
    with torch.device("meta"):
        lm = lc.LongcatFlash(cfg)
    lm.load_state_dict(W, assign=True)
    lm.model.norm = torch.nn.Identity()
    hidden, _ = longcat_apply(lm, inputs_embeds=x, return_logits=False)
    return hidden


def test_expert_shares_add_up_to_the_uncut_double_layer():
    """Four chips' shares of 16 FFN experts, 4 each: each chip's double
    layer, less what every chip computes alike (attention, the dense MLPs,
    the identity experts: the reference's layer holding no FFN expert),
    adds up, with that counted once, to the reference's uncut layer."""
    whole = dataclasses.replace(CFG, num_layers=1, n_routed_experts=16, experts_held=(0, 16))
    W = init_longcat(whole, seed=3).state_dict()
    x = torch.randn(1, 7, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    num = Numerics("fp32")
    rot = ref._rotation(_ref_cfg(whole), 7, x.device)
    want = ref.double_layer(W, 0, x, _ref_cfg(whole), rot, num)
    alike = ref.double_layer(W, 0, x, dict(_ref_cfg(whole), experts_held=[0, 0]), rot, num)
    total = alike.clone()
    p = "model.layers.0.mlp.experts."
    for chip in range(4):
        held = (4 * chip, 4 * chip + 4)
        cfg = dataclasses.replace(whole, experts_held=held)
        sd = dict(W, **{p + n: W[p + n][held[0]:held[1]] for n in ("gate_up_proj", "down_proj")})
        total += _port_layer(cfg, sd, x) - alike
    _close(total, want)
    assert _gap(alike, want) > 1e-4        # the FFN experts' part: 5x the tolerance and more


# -- the beam loop and the refusals -------------------------------------------


def test_beam_scores_match_reference_log_probability(lm):
    R, K, P, N = 2, 3, 4, 5
    prefix = torch.randn(R, P, CFG.hidden_size, generator=torch.Generator().manual_seed(6))
    res = beam_search_batched(lm, prefix, BeamParams(beam_size=K, max_new_tokens=N,
                                                     stop_token=NEVER), dtype=torch.float32)
    W = lm.state_dict()
    c = _ref_cfg(CFG)
    for r in range(R):
        for k in range(K):
            t = res.tokens[r, k]
            x = torch.cat([prefix[r], ref.token_embeds(W, t[:-1])])[None]
            h = ref.longcat_hidden(W, x, c, Numerics("fp32"))[0, P - 1:]
            logp = torch.log_softmax(ref.lm_logits(W, h, Numerics("fp32")), -1)
            want = logp.gather(-1, t[:, None]).mean()
            assert abs(float(res.scores[r, k]) - float(want)) < 1e-5


def test_beam_search_counts_longcat_steps(lm):
    """One grouped expert call a double layer: the prefill's, then each step's."""
    before = (beam_search_batched.decode_steps, moe.grouped_expert_mlp.calls)
    prefix = torch.randn(1, 3, CFG.hidden_size)
    beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=4, stop_token=NEVER),
                        dtype=torch.float32)
    assert beam_search_batched.decode_steps == before[0] + 3
    assert moe.grouped_expert_mlp.calls == before[1] + CFG.num_layers * (1 + 3)


@pytest.mark.parametrize("params", [dict(int8_kv=True), dict(consolidate_every=2),
                                    dict(tile_major=True), dict(fold_prefix=False)],
                         ids=["int8_kv", "consolidated", "tile_major", "replicated_prefix"])
def test_cache_forms_the_latent_cache_lacks_raise(lm, params):
    prefix = torch.randn(1, 3, CFG.hidden_size)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F15"):
        beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=3, **params),
                            dtype=torch.float32)


def test_configs_the_port_lacks_raise():
    hf = dict(dataclasses.asdict(CFG), model_type="longcat_flash")
    assert lc.longcat_config_from_hf(hf).experts_held == (0, CFG.n_routed_experts)
    with pytest.raises(NotImplementedError, match="rope scaling"):
        lc.longcat_config_from_hf(dict(hf, rope_scaling={"rope_type": "yarn", "factor": 4.0}))
    with pytest.raises(NotImplementedError, match="tied LM head"):
        lc.longcat_config_from_hf(dict(hf, tie_word_embeddings=True))
    with pytest.raises(NotImplementedError, match="zero experts of type"):
        lc.longcat_config_from_hf(dict(hf, zero_expert_type="zero"))


def _clipcap(seed=0):
    from clipcap_tpu_torch.config import Config, EncoderConfig
    from clipcap_tpu_torch.models.clipcap import init_clipcap

    config = Config(language_model="longcat-flash-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=4,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    return config, init_clipcap(config, seed=seed)


def test_clipcap_captions_with_longcat_and_refuses_training_and_sampling():
    from clipcap_tpu_torch.inference.engine import SamplingParams, decode
    from clipcap_tpu_torch.models.clipcap import clipcap_loss
    from clipcap_tpu_torch.models.mapper import mapper_apply

    _, model = _clipcap()
    assert isinstance(model.language_model, lc.LongcatFlash)
    assert model.transformer_mapper.config.lm_embedding_size == CFG.hidden_size
    emb = torch.randn(2, 32, generator=torch.Generator().manual_seed(7))
    prefix = mapper_apply(model.transformer_mapper, emb, dtype=torch.float32)
    res = beam_search_batched(model.language_model, prefix,
                              BeamParams(beam_size=2, max_new_tokens=3, stop_token=NEVER),
                              dtype=torch.float32)
    assert res.tokens.shape == (2, 2, 3) and bool(torch.isfinite(res.scores).all())
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F15"):
        clipcap_loss(model, torch.zeros(2, 3, dtype=torch.long), emb)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F15"):
        decode(model.language_model, prefix, torch.Generator(), SamplingParams())


def test_the_published_preset_holds_one_chips_share():
    cfg = LONGCAT_PRESETS["meituan-longcat/LongCat-Flash-Chat"]
    r = cfg.routing
    assert (r.width, r.top_k, r.scale, r.n_held, r.zero_experts) == (768, 12, 6.0, 8, 256)
    assert cfg.num_hidden_layers == 56 and cfg.latent_dim == 576
    assert cfg.mla_scales == pytest.approx((2.0, 12 ** 0.5))


def test_decode_graph_keys_follow_the_longcat_weights(lm):
    """A key's graphs hold a segment per cut plus one: per double layer its
    first attention, its experts, its second attention."""
    key = (6, 3, torch.bfloat16, torch.device("cuda", 0))    # a key only: nothing runs
    graphs = lm.decode_graphs.get(lm, key)
    assert graphs.segments == 1 + 3 * CFG.num_layers == len(lm.cuts) + 1
    assert lm.cuts == [("attn", 0), ("moe", 0), ("attn", 1), ("attn", 2), ("moe", 2),
                       ("attn", 3)]
    lm.model.layers[1].mlps[0].up_proj.weight.data = \
        lm.model.layers[1].mlps[0].up_proj.weight.data.clone()
    assert lm.decode_graphs.get(lm, key) is not graphs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# Kernel-sized widths: D a multiple of 128, F of 64.
CARD_CFG = dataclasses.replace(
    CFG, hidden_size=256, ffn_hidden_size=384, expert_ffn_hidden_size=128, q_lora_rank=64,
    kv_lora_rank=64, num_attention_heads=4, n_routed_experts=16, zero_expert_num=8,
    moe_topk=4, experts_held=(4, 12), vocab_size=1000, name="card")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped expert kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_longcat_beam_search_equals_eager(cuda, monkeypatch):
    """Graphed decode steps give the tokens, lengths and scores of the same
    segments run eagerly, bit for bit (a share of the experts held, the
    shortcut carried across the second attention's cut)."""
    lm = init_longcat(CARD_CFG, seed=9).to(cuda, torch.bfloat16)
    prefix = torch.randn(4, 5, CARD_CFG.hidden_size,
                         generator=torch.Generator().manual_seed(10)).to(cuda)
    bp = BeamParams(beam_size=3, max_new_tokens=8, stop_token=NEVER)
    steps = beam_search_batched.graph_steps
    graphed = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    graphed = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)    # replays only
    assert beam_search_batched.graph_steps > steps
    monkeypatch.setattr(beam_mod, "decode_step_graphs", lambda *a, **k: None)
    eager = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    assert torch.equal(graphed.tokens, eager.tokens)
    assert torch.equal(graphed.seq_lengths, eager.seq_lengths)
    assert torch.equal(graphed.scores, eager.scores)


@pytest.mark.cuda
def test_card_beam_scores_match_the_reference(cuda):
    """The bf16 search on the card, its scores against the float32
    reference over the served tokens (within bf16's reach)."""
    lm = init_longcat(CARD_CFG, seed=11)
    W = {k: v.to(cuda) for k, v in lm.state_dict().items()}
    lm = lm.to(cuda, torch.bfloat16)
    prefix = torch.randn(2, 5, CARD_CFG.hidden_size,
                         generator=torch.Generator().manual_seed(12)).to(cuda)
    res = beam_search_batched(lm, prefix, BeamParams(beam_size=3, max_new_tokens=6,
                                                     stop_token=NEVER), dtype=torch.bfloat16)
    c = _ref_cfg(CARD_CFG)
    for r in range(2):
        x = torch.cat([prefix[r].bfloat16().float()[None].expand(3, -1, -1),
                       ref.token_embeds(W, res.tokens[r, :, :-1])], 1)
        h = ref.longcat_hidden(W, x, c, Numerics("fp32"))[:, 4:]
        logp = torch.log_softmax(ref.lm_logits(W, h, Numerics("fp32")), -1)
        want = logp.gather(-1, res.tokens[r][..., None])[..., 0].mean(-1)
        assert float((res.scores[r] - want).abs().max()) < 0.05
