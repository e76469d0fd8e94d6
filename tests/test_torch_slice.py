"""The captioning slice end to end: the JAX package and the port on one
checkpoint.

The JAX package writes an ``.npz`` + YAML; both packages ``load`` it and
caption the same image embedding.  Beam search and every decode whose
choice is deterministic (top-k = 1) must give identical captions, token
for token, in fp32.  Kernel-against-twin cases need the card and skip on a
machine without one (the CUDA kernels have no CPU mode).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from clipcap_tpu.config import Config, EncoderConfig, save_yaml_config
from clipcap_tpu.inference import generate as jgen
from clipcap_tpu.models import clipcap as jclipcap
from clipcap_tpu.models.gpt2 import GPT2_PRESETS
from clipcap_tpu.train.checkpoint import save_params as jsave_params
from clipcap_tpu_torch.inference import generate as tgen
from clipcap_tpu_torch.models import clipcap as tclipcap
from clipcap_tpu_torch.ops.attention import (fused_sdpa, fused_sdpa_ref, sdpa, sdpa_packed,
                                             sdpa_packed_ref)
from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    config = Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    model = jclipcap.init_clipcap(config, lm_config=GPT2_PRESETS["gpt2-test"], seed=3)
    jsave_params(str(d / "model.npz"), model.params)
    save_yaml_config(config, str(d / "config.yaml"))
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(d / "image.png")
    return d


@pytest.fixture(scope="module")
def both(checkpoint):
    """Both packages loaded from the JAX-written checkpoint, and one image
    embedding from the port's encoder."""
    from clipcap_tpu_torch.encoders.base import get_encoder_from_model

    args = (str(checkpoint / "model.npz"), str(checkpoint / "config.yaml"))
    jmodel, tok = jclipcap.load(*args)
    tmodel, _ = tclipcap.load(*args, device="cpu")
    encoder, transform = get_encoder_from_model(tmodel)
    embedding = encoder(transform(str(checkpoint / "image.png"))[None])
    return jmodel, tmodel, tok, embedding


def test_both_packages_map_the_same_prefix(both):
    jmodel, tmodel, _, emb = both
    assert emb.shape == (1, 32) and np.isfinite(emb).all()
    # fp32 on both sides: 1e-4 covers summation order over 2 mapper layers.
    np.testing.assert_allclose(tmodel.transformer_mapper(emb).numpy(),
                               np.asarray(jmodel.transformer_mapper(emb)), atol=1e-4, rtol=1e-4)


def test_beam_captions_identical(both):
    """Beam 5, folded prefix, 67 new tokens: the same ranked captions, and
    exactly number_to_generate of them (cycling past beam_size)."""
    jmodel, tmodel, tok, emb = both
    prefix = tmodel.transformer_mapper(emb).numpy()
    want = jgen.generate_beam(jmodel, tok, prefix, number_to_generate=9, beam_size=5)
    got = tgen.generate_beam(tmodel, tok, prefix, number_to_generate=9, beam_size=5)
    assert got == want
    assert got[5:] == got[:4]
    assert len(tgen.generate_beam(tmodel, tok, prefix, beam_size=5, entry_length=8)) == 1


def test_sampling_captions_identical_at_top_k_1(both):
    """Nucleus sampling and no-beam sampling (with its repetition and
    sentence-length penalties) at top_k = 1 are deterministic."""
    jmodel, tmodel, tok, emb = both
    prefix = tmodel.transformer_mapper(emb).numpy()
    kw = dict(number_to_generate=3, top_k=1, entry_length=20)
    want = jgen.generate_nucleus_sampling(jmodel, tok, prefix, **kw)
    got = tgen.generate_nucleus_sampling(tmodel, tok, prefix, **kw)
    assert got == want and len(got) == 3
    kw.pop("entry_length")                     # generate() decodes the full 67
    want = jgen.generate(jmodel, tok, emb, **kw)
    got = tgen.generate(tmodel, tok, emb, **kw)
    assert got == want and len(got) == 3


@pytest.mark.parametrize("windowed", [False, True])
def test_clip_transform_matches_jax(checkpoint, windowed):
    from clipcap_tpu.encoders.clip import CLIPTransform as JTransform
    from clipcap_tpu_torch.encoders.clip import CLIPTransform

    kw = dict(n_px=32, use_windowed_embeddings=windowed, window_size=4,
              window_overlap_percentage=10.0 if windowed else 0.0)
    got = CLIPTransform(**kw)(str(checkpoint / "image.png"))
    want = JTransform(**kw)(str(checkpoint / "image.png"))
    assert got.dtype == np.uint8 and got.shape == ((5, 32, 32, 3) if windowed else (32, 32, 3))
    np.testing.assert_array_equal(got, want)


def test_clip_encoder_matches_jax(checkpoint):
    """The encoder both packages build for a model (seeded test-tiny CLIP),
    in fp32: embeddings, text embeddings and rerank similarities to 1e-4."""
    import jax.numpy as jnp

    from clipcap_tpu.encoders.clip import get_clip_encoder as jget
    from clipcap_tpu_torch.encoders.clip import get_clip_encoder

    jenc, transform = jget("test-tiny", dtype=jnp.float32)
    tenc, _ = get_clip_encoder("test-tiny", device="cpu", dtype=torch.float32)
    sample = transform(str(checkpoint / "image.png"))
    captions = ["a cat on a mat", "two dogs", "a red car parked by the sea"]
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tenc(np.stack([sample, sample[::-1]])),
                               jenc(np.stack([sample, sample[::-1]])), **tol)
    np.testing.assert_allclose(tenc.encode_text(captions), jenc.encode_text(captions), **tol)
    np.testing.assert_allclose(tenc.similarity(sample, captions),
                               jenc.similarity(sample, captions), **tol)


def test_port_slice_never_loads_jax(checkpoint):
    """The inference CLI of the port, end to end in a fresh interpreter."""
    code = (
        "import sys\n"
        "from clipcap_tpu_torch.inference.demo import run_inference_demo\n"
        f"sys.argv = ['demo', '--model-path', {str(checkpoint / 'model.npz')!r},\n"
        f"            '--config-path', {str(checkpoint / 'config.yaml')!r},\n"
        f"            '--sample-path', {str(checkpoint / 'image.png')!r},\n"
        "            '--device', 'cpu', '--number-to-generate', '2']\n"
        "assert run_inference_demo() == 0\n"
        "assert 'jax' not in sys.modules, 'the port loaded jax'\n"
        "print('NO-JAX')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "best" in res.stdout and "NO-JAX" in res.stdout


def test_load_on_cuda_raises_without_cuda(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from clipcap_tpu_torch.encoders.clip import get_clip_encoder

    with pytest.raises(RuntimeError, match="CUDA"):
        tclipcap.load(str(checkpoint / "model.npz"), str(checkpoint / "config.yaml"),
                      device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_clip_encoder("test-tiny", device="cuda")


# ---------------------------------------------------------------------------
# The kernels against their twins (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# fp32: the kernel sums in another order (1e-4 abs); bf16: the twin rounds
# the softmax weights to bf16 and the kernel keeps them fp32 (2e-2 abs at
# O(1) outputs).
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,Rm", [(1, 1), (5, 4)])
def test_flash_decode_kernel_matches_twin(cuda, dtype, K, Rm):
    g = torch.Generator(device=cuda).manual_seed(K)
    R, H, U = 4, 3, 384
    q = torch.randn(R, H, K, 64, generator=g, device=cuda).to(dtype)
    kv = torch.randn(R, H, U, 128, generator=g, device=cuda).to(dtype)
    mask = torch.where(torch.rand(Rm, K, U, generator=g, device=cuda) < 0.5, 0.0, -1e9)
    mask[..., 0] = 0.0
    for u_valid in (1, 63, 64, 65, 200, U):
        got = flash_decode(q, kv, mask, u_valid)
        want = flash_decode_ref(q, kv, mask, u_valid)
        torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype], rtol=0)


def _before_nan(t):
    """``t`` copied to the start of a larger buffer that holds NaN past its
    end: a kernel that reads outside its operand turns its output NaN."""
    buf = torch.full((t.numel() + 4096,), float("nan"), dtype=t.dtype, device=t.device)
    out = buf[:t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _attention_cases(first, shape):
    """The shapes of the attention kernel tests: ``first`` (with their
    original ids), then rows that end a query tile or a 16-key block, or
    fall one short or one past (N = 1, 63, 64, 65, 257), 1,024 heads (the
    persistent grid, one block an SM, walks its heads more than once), and
    operands followed by NaN.  ``shape(B, H, N)`` orders a case's sizes as
    the test takes them."""
    cases = [pytest.param(*case, False, id="-".join(map(str, case))) for case in first]
    cases += [pytest.param(*shape(2, 4, N), causal, False, id=f"tail-{N}-{causal}")
              for N in (1, 63, 64, 65, 257) for causal in (False, True)]
    cases += [pytest.param(*shape(64, 16, 65), False, False, id="wrap-64x16-65")]
    cases += [pytest.param(*shape(3, 4, 65), causal, True, id=f"nan-outside-65-{causal}")
              for causal in (False, True)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,causal,nan_outside", _attention_cases(
    [(3, 50, 12, False), (2, 77, 8, True), (1, 577, 4, False), (1, 577, 4, True)],
    lambda B, H, N: (B, N, H)))
def test_sdpa_packed_kernel_matches_twin(cuda, dtype, B, N, H, causal, nan_outside):
    g = torch.Generator(device=cuda).manual_seed(N)
    qkv = torch.randn(B, N, 3 * H * 64, generator=g, device=cuda).to(dtype)
    if nan_outside:
        qkv = _before_nan(qkv)
    got = sdpa_packed(qkv, H, causal=causal)
    want = sdpa_packed_ref(qkv, H, causal=causal)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,N,causal,nan_outside", _attention_cases(
    [(8, 12, 50, False), (5, 8, 77, True), (4, 16, 257, False), (2, 16, 512, False),
     (2, 4, 130, True)], lambda B, H, N: (B, H, N)))
def test_fused_sdpa_kernel_matches_twin(cuda, dtype, B, H, N, causal, nan_outside):
    g = torch.Generator(device=cuda).manual_seed(N)
    q, k, v = (torch.randn(B, H, N, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    if nan_outside:
        q, k, v = map(_before_nan, (q, k, v))
    before = fused_sdpa.launches
    got = fused_sdpa(q, k, v, causal=causal)
    assert fused_sdpa.launches == before + 1
    want = fused_sdpa_ref(q, k, v, causal=causal)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype], rtol=0)
    # The façade: [B, N, H, Dh] in, one launch, the context as [B, N, H·Dh].
    qn, kn, vn = (t.transpose(1, 2) for t in (q, k, v))
    got = sdpa(qn, kn, vn, causal=causal)
    assert fused_sdpa.launches == before + 2
    torch.testing.assert_close(got.float(), want.transpose(1, 2).reshape(B, N, H * 64).float(),
                               atol=KERNEL_TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_sdpa_c_entries_refuse_what_tma_cannot_address(cuda):
    """The bf16 C entries return cudaErrorInvalidValue (1) for a base off
    16 bytes, which the copy engine cannot address (the wrappers never pass
    one), and launch for the same operands aligned."""
    from clipcap_tpu_torch.ops import _build

    lib = _build.load_library()
    B, N, H, bf16 = 2, 10, 4, _build.DTYPE_CODES[torch.bfloat16]
    qkv = torch.zeros(B * N * 3 * H * 64 + 8, dtype=torch.bfloat16, device=cuda)
    out = torch.empty(B * N * H * 64 + 8, dtype=torch.bfloat16, device=cuda)
    stream = _build.stream_of(qkv)
    p, o = qkv.data_ptr(), out.data_ptr()
    assert lib.clipcap_sdpa_packed(p + 2, o, B, N, H, 0, bf16, 0.125, stream) == 1
    assert lib.clipcap_sdpa_packed(p, o + 8, B, N, H, 0, bf16, 0.125, stream) == 1
    assert lib.clipcap_sdpa_packed(p, o, B, N, H, 0, bf16, 0.125, stream) == 0
    for bad in range(4):
        ptrs = [p, p, p, o]
        ptrs[bad] += 4
        assert lib.clipcap_fused_sdpa(*ptrs, B, H, N, 0, bf16, 0.125, stream) == 1
    assert lib.clipcap_fused_sdpa(p, p, p, o, B, H, N, 0, bf16, 0.125, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_sdpa_kernel_raises_on_what_it_cannot_take(cuda):
    q = torch.zeros(1, 2, 10, 32, device=cuda)
    with pytest.raises(ValueError, match="Dh=64"):
        fused_sdpa(q, q, q)
    q = torch.zeros(1, 2, 10, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fused_sdpa(q, q, q)
    q = torch.zeros(1, 10, 2, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sdpa(q, q, q)
