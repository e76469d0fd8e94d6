"""The port's head-major attention (``fused_sdpa`` and the ``sdpa`` façade)
against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
``fused_sdpa`` is a Pallas kernel and runs in interpret mode on the CPU, as
``tests/test_pallas.py`` runs it; the port's side is the kernel's plain
twin, which is what a CPU tensor reaches.  Tolerance 2e-5 (fp32): both
sides compute the same fp32 softmax and value product in another
summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.ops import attention as jattn
from clipcap_tpu_torch.ops import attention

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [7, 51, 64, 130])
def test_fused_sdpa_ref_matches_pallas(n, causal):
    q, k, v = _inputs(n, (3, 4, n, 64))
    want = jattn.fused_sdpa(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = attention.fused_sdpa_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_facade_matches_jax_on_the_cpu(causal):
    """``sdpa(fused=True)``, [B, N, H, Dh] in and [B, N, H·Dh] out, with an
    explicit scale; a CPU tensor never launches the kernel."""
    q, k, v = _inputs(5, (3, 51, 4, 64))
    want = jattn.sdpa(*map(jnp.asarray, (q, k, v)), scale=0.1, causal=causal, fused=True)
    before = attention.fused_sdpa.launches
    got = attention.sdpa(*map(torch.from_numpy, (q, k, v)), scale=0.1, causal=causal)
    assert attention.fused_sdpa.launches == before
    assert got.shape == (3, 51, 4 * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdpa_facade_keeps_the_unfused_form_with_a_bias():
    q, k, v = _inputs(6, (2, 9, 3, 64))
    bias = (np.random.default_rng(7).standard_normal((2, 3, 9, 9)) * 0.5).astype(np.float32)
    want = jattn.sdpa(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias))
    got = attention.sdpa(*map(torch.from_numpy, (q, k, v)), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fused_sdpa_rejects_long_rows_in_both_packages():
    q = np.zeros((1, 1, 600, 64), np.float32)
    with pytest.raises(ValueError):
        jattn.fused_sdpa(*[jnp.asarray(q)] * 3)
    with pytest.raises(ValueError, match="N<=512"):
        attention.fused_sdpa(*[torch.from_numpy(q)] * 3)


def test_fused_sdpa_on_the_cpu_takes_any_head_width():
    """The twin has no Dh = 64 limit (only the CUDA kernel does)."""
    q, k, v = _inputs(8, (2, 3, 20, 16))
    want = jattn.fused_sdpa(*map(jnp.asarray, (q, k, v)))
    got = attention.fused_sdpa(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
