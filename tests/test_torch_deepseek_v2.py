"""DeepSeek-V2 as the captioner's language model (``models/deepseek_v2.py``).

At the tiny preset ``deepseek-v2-test`` (hidden 64, 4 heads, latent rank
32, rope 8, nope 16, v 16, 8 experts top-2, 2 shared, 1 dense + 2 MoE
layers, vocabulary 512; seeded), on the CPU, in float32: the port against
the benchmark's plain reference (``portbench/reference/deepseek_v2.py``),
and both against ``transformers``' ``DeepseekV2ForCausalLM`` where it is
installed.  Tolerances: 2e-5 of the logits' scale for float32 against
float32 (summation order only; the reference computes attention
decompressed and RoPE as complex rotations, the port's decode absorbed).

The tests marked ``cuda`` hold the grouped expert kernel to its twin at the
benchmark cell's shapes and graphed beam search to the same segments run
eagerly; this file imports no JAX, so on the card: ``python -m pytest
tests/test_torch_deepseek_v2.py --noconftest -m cuda -q``.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models.deepseek_v2 import (DSV2_PRESETS, dsv2_apply, dsv2_embed_tokens,
                                                  init_dsv2, init_latent_cache)
from clipcap_tpu_torch.ops import moe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import deepseek_v2 as ref  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402

CFG = DSV2_PRESETS["deepseek-v2-test"]
NEVER = -1      # a stop token no step emits


def _ref_cfg(cfg) -> dict:
    """The reference's dict of HF config keys for a port config."""
    c = dataclasses.asdict(cfg)
    if cfg.rope_scaling is not None:
        c["rope_scaling"] = dict(dataclasses.asdict(cfg.rope_scaling), type="yarn")
    return c


@pytest.fixture(scope="module")
def lm():
    return init_dsv2(CFG, seed=5)


def _ref_logits(lm, embeds):
    W = lm.state_dict()
    num = Numerics("fp32")
    return ref.lm_logits(W, ref.dsv2_hidden(W, embeds, _ref_cfg(lm.config), num), num)


def _close(got, want, tol=2e-5):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, float((got - want).abs().max())


def test_forward_matches_reference(lm):
    x = torch.randn(3, 9, CFG.hidden_size, generator=torch.Generator().manual_seed(0))
    logits, _ = dsv2_apply(lm, inputs_embeds=x)
    _close(logits, _ref_logits(lm, x))


def test_prefill_then_beam_decode_matches_reference(lm):
    """Prefill the folded prefix, then beam decode steps through the latent
    cache with beams reordered at every step (the ancestry mask): each
    step's logits equal the reference's full forward over the beam's own
    history."""
    g = torch.Generator().manual_seed(1)
    R, K, P, N = 2, 3, 4, 6
    B = R * K
    prefix = torch.randn(R, P, CFG.hidden_size, generator=g)
    cache = init_latent_cache(CFG, B, N, dtype=torch.float32, beam_size=K, prefix_slots=P)
    dsv2_apply(lm, inputs_embeds=prefix, kv_cache=cache, cache_index=0, return_logits=False)
    own = torch.arange(B) % K
    ancestry = own[:, None].repeat(1, N)
    history = [[] for _ in range(B)]
    for step in range(1, N):
        pos = P + step - 1
        ancestry[:, pos - P] = own
        tok = torch.randint(0, CFG.vocab_size, (B,), generator=g)
        for b in range(B):
            history[b].append(int(tok[b]))
        logits, _ = dsv2_apply(lm, inputs_embeds=dsv2_embed_tokens(lm, tok[:, None]),
                               kv_cache=cache, cache_index=pos, beam_size=K, ancestry=ancestry,
                               cache_base=P)
        for b in range(B):
            x = torch.cat([prefix[b // K], dsv2_embed_tokens(lm, torch.tensor(history[b]))])
            _close(logits[b, 0], _ref_logits(lm, x[None])[0, -1])
        src = torch.randint(0, K, (R, K), generator=g)                    # beams reordered
        ancestry = ancestry.reshape(R, K, N).gather(1, src[..., None].expand(R, K, N))
        ancestry = ancestry.reshape(B, N)
        history = [list(history[r * K + int(src[r, k])]) for r in range(R) for k in range(K)]


def _expert_loop(x, w13, w2, offsets):
    """Each expert's SwiGLU by plain ``F.linear`` on its rows."""
    Fw = w2.shape[-1]
    out = torch.zeros(x.shape[0], w2.shape[1])
    for e, (lo, hi) in enumerate(zip(offsets[:-1].tolist(), offsets[1:].tolist())):
        gu = F.linear(x[lo:hi], w13[e])
        out[lo:hi] = F.linear(F.silu(gu[:, :Fw]) * gu[:, Fw:], w2[e])
    return out


@pytest.mark.parametrize("counts", [[3, 0, 5, 1, 0, 7, 2, 4], [0, 0, 0, 22, 0, 0, 0, 0]],
                         ids=["empty_experts", "one_expert"])
def test_grouped_twin_matches_expert_loop(counts):
    g = torch.Generator().manual_seed(2)
    E, D, Fw = len(counts), 32, 16
    offsets = torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int32)
    x = torch.randn(sum(counts), D, generator=g)
    w13 = torch.randn(E, 2 * Fw, D, generator=g) * 0.1
    w2 = torch.randn(E, D, Fw, generator=g) * 0.1
    before = moe.grouped_expert_mlp.calls, moe.grouped_expert_mlp.rows
    got = moe.grouped_expert_mlp(x, w13, w2, offsets)
    assert (moe.grouped_expert_mlp.calls, moe.grouped_expert_mlp.rows) == (
        before[0] + 1, before[1] + sum(counts))
    torch.testing.assert_close(got, _expert_loop(x, w13, w2, offsets), rtol=1e-5, atol=1e-6)


def test_expert_groups_sort_pairs_by_expert():
    experts = torch.tensor([[3, 1], [1, 0], [3, 2], [0, 3]])
    order, inv, offsets = moe.expert_groups(experts, 5)
    flat = experts.reshape(-1)
    assert flat[order].tolist() == sorted(flat.tolist())
    assert offsets.tolist() == [0, 2, 4, 5, 8, 8] and offsets.dtype == torch.int32
    assert torch.equal(order[inv], torch.arange(8))


def test_moe_layer_matches_reference(lm):
    """The port's MoE layer (routing, the sort by expert, the grouped twin,
    the weighted sum, the shared experts) against the reference's loop over
    every expert, on a layer whose tokens leave some experts empty."""
    layer = lm.model.layers[1]
    h = torch.randn(1, 5, CFG.hidden_size, generator=torch.Generator().manual_seed(3))
    _, idx = dsv2._route(layer.mlp, h[0], CFG)
    assert len(set(idx.flatten().tolist())) < CFG.n_routed_experts       # some experts empty
    got = dsv2._moe(layer.mlp, h, CFG)
    want = ref._moe(lm.state_dict(), "model.layers.1.mlp.", h, _ref_cfg(CFG), Numerics("fp32"))
    _close(got, want)


def test_yarn_frequencies_and_softmax_scale():
    """YaRN's inverse frequencies and DeepSeek-V2-Lite's softmax scale
    against the formulas, computed here in float64."""
    cfg = DSV2_PRESETS["deepseek-ai/DeepSeek-V2-Lite"]
    r, base, s = 64, 10000.0, 40.0
    i = np.arange(0, r, 2) / r
    extra, inter = base ** -i, base ** -i / s

    def corr(rot):
        return r * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), r - 1)
    ramp = np.clip((np.arange(r // 2) - lo) / (hi - lo), 0, 1)
    want = inter * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(dsv2.rope_inv_freq(cfg).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(ref.rope_frequencies(_ref_cfg(cfg)).numpy(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert math.isclose(dsv2.softmax_scale(cfg), 192 ** -0.5 * m * m, rel_tol=1e-12)
    assert math.isclose(ref.attention_scale(_ref_cfg(cfg)), 192 ** -0.5 * m * m, rel_tol=1e-12)
    cs = dsv2.rope_cos_sin(cfg, torch.arange(3))              # attention factor m / m = 1
    torch.testing.assert_close(cs[:, 0] ** 2 + cs[:, 1] ** 2, torch.ones(3, r))


def test_port_and_reference_match_transformers():
    """Through the HF-key loader (per-expert keys stacked), with
    ``rope_scaling`` off, where the in-library model and DeepSeek's agree."""
    transformers = pytest.importorskip("transformers")
    hc = transformers.DeepseekV2Config(
        vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
        q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2, first_k_dense_replace=1,
        norm_topk_prob=False, rope_scaling=None, max_position_embeddings=512,
        topk_method="greedy", n_group=1, topk_group=1)
    torch.manual_seed(0)
    hf = transformers.DeepseekV2ForCausalLM(hc).eval()
    cfg = dsv2.dsv2_config_from_hf(hc.to_dict(), name="hf-tiny")
    assert cfg.rope_scaling is None
    port = dsv2.dsv2_from_hf(hf.state_dict(), cfg)
    ids = torch.randint(0, 512, (2, 9), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = hf(input_ids=ids).logits
        got, _ = dsv2_apply(port, input_ids=ids)
        reference = _ref_logits(port, dsv2_embed_tokens(port, ids))
    _close(got, want)
    _close(reference, want)


def test_beam_scores_match_reference_log_probability(lm):
    """Each beam's normalised score is the reference's mean log-probability
    of its tokens after the prefix."""
    R, K, P, N = 2, 3, 4, 5
    prefix = torch.randn(R, P, CFG.hidden_size, generator=torch.Generator().manual_seed(6))
    res = beam_search_batched(lm, prefix, BeamParams(beam_size=K, max_new_tokens=N,
                                                     stop_token=NEVER), dtype=torch.float32)
    W = lm.state_dict()
    for r in range(R):
        for k in range(K):
            t = res.tokens[r, k]
            x = torch.cat([prefix[r], ref.token_embeds(W, t[:-1])])[None]
            h = ref.dsv2_hidden(W, x, _ref_cfg(CFG), Numerics("fp32"))[0, P - 1:]
            logp = torch.log_softmax(ref.lm_logits(W, h, Numerics("fp32")), -1)
            want = logp.gather(-1, t[:, None]).mean()
            assert abs(float(res.scores[r, k]) - float(want)) < 1e-5


def test_beam_search_counts_dsv2_steps(lm):
    before = beam_search_batched.decode_steps, beam_search_batched.host_syncs
    prefix = torch.randn(1, 3, CFG.hidden_size)
    beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=4, stop_token=NEVER),
                        dtype=torch.float32)
    assert beam_search_batched.decode_steps == before[0] + 3
    assert beam_search_batched.host_syncs == before[1] + 3


@pytest.mark.parametrize("params", [dict(int8_kv=True), dict(consolidate_every=2),
                                    dict(tile_major=True), dict(fold_prefix=False)],
                         ids=["int8_kv", "consolidated", "tile_major", "replicated_prefix"])
def test_cache_forms_the_latent_cache_lacks_raise(lm, params):
    prefix = torch.randn(1, 3, CFG.hidden_size)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=3, **params),
                            dtype=torch.float32)


def test_configs_the_port_lacks_raise():
    hf = {k: v for k, v in dataclasses.asdict(CFG).items() if k != "rope_scaling"}
    with pytest.raises(NotImplementedError, match="query LoRA"):
        dsv2.dsv2_config_from_hf(dict(hf, num_key_value_heads=4, q_lora_rank=16))
    with pytest.raises(NotImplementedError, match="group-limited"):
        dsv2.dsv2_config_from_hf(dict(hf, topk_method="group_limited_greedy"))


def _clipcap(seed=0):
    from clipcap_tpu_torch.config import Config, EncoderConfig
    from clipcap_tpu_torch.models.clipcap import init_clipcap

    config = Config(language_model="deepseek-v2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=4,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    return config, init_clipcap(config, seed=seed)


def test_clipcap_captions_with_dsv2_and_refuses_training():
    from clipcap_tpu_torch.inference.engine import SamplingParams, decode
    from clipcap_tpu_torch.models.clipcap import clipcap_loss
    from clipcap_tpu_torch.models.mapper import mapper_apply

    _, model = _clipcap()
    assert isinstance(model.language_model, dsv2.DeepseekV2)
    emb = torch.randn(2, 32, generator=torch.Generator().manual_seed(7))
    prefix = mapper_apply(model.transformer_mapper, emb, dtype=torch.float32)
    res = beam_search_batched(model.language_model, prefix,
                              BeamParams(beam_size=2, max_new_tokens=3, stop_token=NEVER),
                              dtype=torch.float32)
    assert res.tokens.shape == (2, 2, 3) and bool(torch.isfinite(res.scores).all())
    assert model.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        clipcap_loss(model, torch.zeros(2, 3, dtype=torch.long), emb)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode(model.language_model, prefix, torch.Generator(), SamplingParams())


def test_decode_graph_keys_follow_the_dsv2_weights(lm):
    """A key's graphs hold a segment per cut plus one, and are dropped when
    a layer's weight storage moves."""
    key = (6, 3, torch.bfloat16, torch.device("cuda", 0))    # a key only: nothing runs
    graphs = lm.decode_graphs.get(lm, key)
    assert graphs.segments == 1 + CFG.num_hidden_layers + 2 == len(lm.cuts) + 1
    assert lm.decode_graphs.get(lm, key) is graphs
    layer = lm.model.layers[2].mlp.experts
    layer.down_proj.data = layer.down_proj.data.clone()
    assert lm.decode_graphs.get(lm, key) is not graphs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# Kernel-sized widths: D a multiple of 128, F of 64.
CARD_CFG = dataclasses.replace(CFG, hidden_size=256, intermediate_size=512,
                               moe_intermediate_size=128, num_attention_heads=2,
                               kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                               v_head_dim=32, n_routed_experts=8, num_experts_per_tok=3,
                               vocab_size=1000, name="card")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped expert kernel has no CPU mode")
    return torch.device("cuda")


def _routed_offsets(counts, dev):
    return torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int32, device=dev)


def _cell_counts(kind: str, g: torch.Generator):
    """Rows per expert of 640 tokens × 6 experts over 64: the top 6 of
    random router logits, skewed ones (a few experts take most pairs), or
    with expert 17 chosen by no token."""
    T, E, k = 640, 64, 6
    logits = torch.randn(T, E, generator=g)
    if kind == "skewed":
        logits = logits + torch.linspace(4, 0, E)
    if kind == "one_empty":
        logits[:, 17] = -1e9
    idx = logits.topk(k, dim=-1).indices
    return torch.bincount(idx.flatten(), minlength=E).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "skewed", "one_empty"])
def test_grouped_kernel_matches_twin_at_cell_shapes(cuda, kind):
    g = torch.Generator().manual_seed(8)
    counts = _cell_counts(kind, g)
    if kind == "one_empty":
        assert counts[17] == 0
    if kind == "skewed":
        assert max(counts) > 128                       # several row tiles in one block
    E, D, Fw = 64, 2048, 1408
    M = sum(counts)
    x = torch.randn(M, D, generator=g).to(cuda, torch.bfloat16)
    w13 = (torch.randn(E, 2 * Fw, D, generator=g) * 0.02).to(cuda, torch.bfloat16)
    w2 = (torch.randn(E, D, Fw, generator=g) * 0.02).to(cuda, torch.bfloat16)
    offsets = _routed_offsets(counts, cuda)
    launches = moe.grouped_expert_mlp.launches
    got = moe.grouped_expert_mlp(x, w13, w2, offsets)
    torch.cuda.synchronize()
    assert moe.grouped_expert_mlp.launches == launches + 2
    want = moe.grouped_expert_mlp_ref(x, w13, w2, offsets)
    # bf16 outputs of fp32 sums taken in another order: the rounding of h
    # can differ by one bf16 ulp, which the down product carries.
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    assert err < 2e-2, err


@pytest.mark.cuda
def test_graphed_dsv2_beam_search_equals_eager(cuda, monkeypatch):
    """Graphed decode steps give the tokens, lengths and scores of the
    same segments run eagerly, bit for bit."""
    lm = init_dsv2(CARD_CFG, seed=9).to(cuda, torch.bfloat16)
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
