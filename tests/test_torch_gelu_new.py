"""``ops/layers.py::gelu_new``: GPT-2's tanh GELU as one ATen ``gelu``.

On the CPU: one ``aten::gelu`` a call (one ``aten::gelu_backward`` under
autograd) in bf16 and fp32, and one a block call in a GPT-2 beam search;
fp32 values against the JAX package's ``gelu_new`` and gradients against
autograd through the op-by-op formula; every bf16 value in [-12, 12]
within one bf16 ulp of the float64 formula, which the op-by-op chain in
bf16 misses.  The tests marked ``cuda`` import no JAX: run them with
``python -m pytest tests/test_torch_gelu_new.py --noconftest -m cuda -q``.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clipcap_tpu_torch.convert import gpt2_from_params
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models.gpt2 import GPT2_PRESETS, GPT2Config, init_gpt2
from clipcap_tpu_torch.ops.layers import ACTIVATIONS, gelu_new

NEVER = -1    # a stop token no step emits: the search runs to max_new_tokens


def _formula(x):
    """HF ``gelu_new`` op by op in ``x``'s dtype, each op rounding to it."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _aten_counts(fn) -> dict:
    """ATen ops dispatched by one call of ``fn``, by name, by ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    counts = {}
    for e in prof.events():
        if e.name.startswith("aten::"):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _misses_one_bf16_ulp(got, want) -> int:
    """Elements of bf16 ``got`` more than one bf16 ulp from ``want``
    (floored at 2^-20 near zero, the rule of ``test_torch_ops.py``)."""
    assert got.dtype == torch.bfloat16
    want = want.double()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -13))) - 7)
    return int(((got.double() - want).abs() > ulp).sum())


def _every_bf16(lo: float, hi: float):
    """Every finite bf16 value in [lo, hi], once."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x) & (x >= lo) & (x <= hi)]
    return x.float().unique().bfloat16()


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_one_aten_gelu_a_call(dtype, grad):
    """``gelu_new`` dispatches exactly one ``aten::gelu`` and none of the
    chain's ops; its backward one ``aten::gelu_backward``.  ``"gelu"``
    (``jax.nn.gelu``'s default, the same formula) is the same function."""
    assert ACTIVATIONS["gelu_new"] is gelu_new and ACTIVATIONS["gelu"] is gelu_new
    x = torch.randn(3, 7, 64, generator=torch.Generator().manual_seed(24)).to(dtype)
    chain = {"aten::tanh", "aten::mul", "aten::add", "aten::pow"}
    if not grad:
        counts = _aten_counts(lambda: gelu_new(x))
        assert counts.get("aten::gelu") == 1 and not chain & set(counts), counts
        return
    x.requires_grad_()
    y = gelu_new(x)
    counts = _aten_counts(lambda: y.backward(torch.ones_like(y)))
    assert counts.get("aten::gelu_backward") == 1, counts
    assert not (chain | {"aten::tanh_backward"}) & set(counts), counts


def test_fp32_matches_jax_and_the_formula_gradient():
    """fp32: values those of the JAX package's ``gelu_new`` (1e-5, as
    ``test_layers_match_jax``); the input gradient that of autograd through
    the op-by-op formula, to 1e-6 relative over a few fp32 ulps of the O(1)
    values (where ``1 + tanh`` cancels, x < -5, the formula's gradient is
    itself only a few ulps of 1)."""
    from clipcap_tpu.ops import layers as jlayers     # the cuda tests here import no JAX

    import jax.numpy as jnp

    g = torch.Generator().manual_seed(24)
    x = torch.cat([torch.randn(4 * 37 * 64, generator=g) * 3, torch.linspace(-20, 20, 4001)])
    want = jlayers.gelu_new(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(gelu_new(x).numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    up = torch.randn(x.shape, generator=g)
    grads = []
    for fn in (gelu_new, _formula):
        leaf = x.clone().requires_grad_()
        (fn(leaf) * up).sum().backward()
        grads.append(leaf.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-5, rtol=1e-6)


def test_every_bf16_value_within_one_ulp():
    """Every bf16 value in [-12, 12]: the fused form, float32 inside and
    one rounding, lands within one bf16 ulp of the float64 formula; the
    op-by-op chain, rounding after each op, misses on hundreds."""
    x = _every_bf16(-12.0, 12.0)
    want = _formula(x.double())
    assert _misses_one_bf16_ulp(gelu_new(x), want) == 0
    assert _misses_one_bf16_ulp(_formula(x), want) > 100


def test_beam_search_runs_one_gelu_a_block_call():
    """A GPT-2 beam search on the CPU: one ``aten::gelu`` per block for the
    prefill and for each decode step, and no ``aten::tanh``."""
    cfg = GPT2_PRESETS["gpt2-test"]
    lm = gpt2_from_params(init_gpt2(cfg, seed=4), cfg)
    prefix = torch.randn(2, 4, cfg.n_embd, generator=torch.Generator().manual_seed(2))
    bp = BeamParams(beam_size=3, max_new_tokens=5, stop_token=NEVER)
    steps = beam_search_batched.decode_steps
    counts = _aten_counts(lambda: beam_search_batched(lm, prefix, bp, dtype=torch.float32))
    steps = beam_search_batched.decode_steps - steps
    assert steps == bp.max_new_tokens - 1
    assert counts.get("aten::gelu") == cfg.n_layer * (1 + steps), counts
    assert "aten::tanh" not in counts


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# Head size 64, as the decode kernel takes it.
CARD_LM = GPT2Config(vocab_size=1000, n_positions=128, n_embd=128, n_layer=3, n_head=2,
                     name="card")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: counts kernel launches and replays CUDA graphs")
    return torch.device("cuda")


def _kernels(fn) -> int:
    """Device kernels launched by one call of ``fn``, by ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def _one_launch(dev):
    """A bf16 [480, 6400] input (a GPT-2 XL beam step's ``c_fc`` output):
    one kernel forward, one backward, within one bf16 ulp of the float64
    formula."""
    g = torch.Generator(device=dev).manual_seed(24)
    x = (torch.randn(480, 6400, generator=g, device=dev) * 3).bfloat16()
    assert _kernels(lambda: gelu_new(x)) == 1
    leaf = x.clone().requires_grad_()
    y = gelu_new(leaf)
    up = torch.ones_like(y)
    assert _kernels(lambda: torch.autograd.grad(y, leaf, up, retain_graph=True)) == 1
    assert _misses_one_bf16_ulp(gelu_new(x).cpu(), _formula(x.cpu().double())) == 0


def _graphed_decode(dev, monkeypatch):
    """A tiny GPT-2's graphed beam search: tokens, lengths and scores
    bit-identical to its eager segments."""
    lm = gpt2_from_params(init_gpt2(CARD_LM, seed=5), CARD_LM).to(dev, torch.bfloat16)
    bp = BeamParams(beam_size=5, max_new_tokens=12, stop_token=NEVER)
    prefix = torch.randn(3, 4, CARD_LM.n_embd, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    monkeypatch.setattr(beam_mod, "decode_step_graphs", lambda *a, **k: None)
    want = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    monkeypatch.undo()
    graphed = beam_search_batched.graph_steps
    got = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert beam_search_batched.graph_steps > graphed
    for name in ("tokens", "seq_lengths", "scores"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_launch", "graphed_decode"])
def test_on_the_card(cuda, case, monkeypatch):
    if case == "one_launch":
        _one_launch(cuda)
    else:
        _graphed_decode(cuda, monkeypatch)
