"""The preprocess stage of the port against the JAX package's, and its
patch-embed kernel's twin against the Pallas kernel.

Inputs are made with numpy from a seed and fed to both packages.  The
Pallas ``patch_embed_fused`` runs in interpret mode on the CPU, as the JAX
package's own tests run it; the port's side is the kernel's plain twin,
which a CPU tensor reaches.  Tolerances: the twin and the Pallas kernel
both round the pixels to bf16 exactly, take bf16 weights and sum in fp32,
so they differ by the summation order and the last rounding to bf16: one
bf16 ulp of the largest output, ``2**-7 · max|ref|``.  Whole bf16 forwards
(the encoder, the CLI) round at other places in the two frameworks:
``0.02 · max|ref|``, the JAX package's own tolerance for its patch kernel
in the forward.  Kernel-against-twin cases need the card and skip here.
"""
import io
import json
import tarfile
from argparse import ArgumentParser
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from clipcap_tpu.encoders.args import add_encoder_args as jadd_encoder_args
from clipcap_tpu.models import clip_vit as jclip
from clipcap_tpu.ops.patch_embed import patch_embed_fused as jpatch_embed_fused
from clipcap_tpu.preprocess import reader as jreader
from clipcap_tpu.preprocess.args import add_preprocess_args as jadd_preprocess_args
from clipcap_tpu.preprocess.preprocess import preprocess as jpreprocess
from clipcap_tpu.preprocess.runner import Sampler as JSampler
from clipcap_tpu.utils.braceexpand import braceexpand as jbraceexpand
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.encoders.args import add_encoder_args
from clipcap_tpu_torch.models import clip_vit
from clipcap_tpu_torch.ops.patch_embed import (BYTES, RUNS, patch_embed, patch_embed_ref,
                                               patch_embed_supported, pixel_path)
from clipcap_tpu_torch.preprocess import distributor, reader
from clipcap_tpu_torch.preprocess.args import add_preprocess_args
from clipcap_tpu_torch.preprocess.preprocess import preprocess, start_preprocess
from clipcap_tpu_torch.preprocess.runner import Sampler
from clipcap_tpu_torch.utils.braceexpand import braceexpand

torch.set_num_threads(1)
GEOMETRIES = [(3, 32, 48, 16, 64), (2, 28, 28, 14, 64), (2, 64, 96, 32, 64)]


def _patch_inputs(seed, B, H, W, P, D):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    w = (rng.standard_normal((3 * P * P, D)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(D) * 0.1).astype(np.float32)
    # bf16 values on both sides
    w = torch.from_numpy(w).to(torch.bfloat16)
    bias = torch.from_numpy(bias).to(torch.bfloat16)
    return imgs, w, bias


def _jnp_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


# ---------------------------------------------------------------------------
# The patch-embed twin against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("B,H,W,P,D", GEOMETRIES)
def test_patch_embed_ref_matches_pallas(B, H, W, P, D, with_bias):
    """(2, 28, 28, 14): a patch row of 42 values; (2, 64, 96, 32): three
    patches per row, which the Pallas kernel pads to eight."""
    imgs, w, bias = _patch_inputs(B + P, B, H, W, P, D)
    bias = bias if with_bias else None
    want = jpatch_embed_fused(jnp.asarray(imgs), _jnp_bf16(w),
                              None if bias is None else _jnp_bf16(bias), P)
    want = np.asarray(want, np.float32)
    got = patch_embed_ref(torch.from_numpy(imgs), w, bias, P)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (B, (H // P) * (W // P), D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_patch_embed_wrapper_takes_twin_on_cpu():
    imgs, w, bias = _patch_inputs(0, *GEOMETRIES[1])
    before = patch_embed.launches
    torch.testing.assert_close(patch_embed(torch.from_numpy(imgs), w, bias, 14),
                               patch_embed_ref(torch.from_numpy(imgs), w, bias, 14),
                               rtol=0, atol=0)
    assert patch_embed.launches == before        # the count is of kernel launches


@pytest.mark.parametrize("shape,patch,ptr,path", [
    ((256, 224, 224, 3), 14, 0, 0),                  # ViT-L/14: span, copy engine
    ((512, 224, 224, 3), 32, 0, RUNS),               # ViT-B/32: runs, copy engine
    ((3, 32, 32, 3), 16, 0, RUNS),                   # test-tiny
    ((3, 32, 48, 3), 16, 0, RUNS),                   # W = 48: rows of 144 bytes
    ((2, 28, 28, 3), 14, 0, BYTES),                  # a patch row of 1,176 bytes
    ((512, 224, 224, 3), 32, 1, RUNS | BYTES),       # a batch off 16-byte alignment
    ((256, 224, 224, 3), 14, 8, BYTES),
    ((256, 336, 336, 3), 14, 0, 0),                  # ViT-L/14@336px: span, copy engine
])
def test_patch_embed_pixel_path(shape, patch, ptr, path):
    """The copy engine takes what it can address (16-byte aligned starts and
    lengths); everything else takes the bytes path of the same kernel."""
    assert pixel_path(shape, patch, ptr) == path


def test_patch_embed_supported_gating():
    u8 = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    assert patch_embed_supported(u8, 16)
    assert not patch_embed_supported(u8.to(torch.bfloat16), 16)    # float input
    assert not patch_embed_supported(u8, 15)                         # ragged grid
    assert not patch_embed_supported(u8[..., :1], 16)                # not RGB


@pytest.fixture(scope="module")
def tiny_vision():
    cfg = jclip.get_clip_config("test-tiny")
    params = jclip.init_clip(cfg, seed=0)
    port = convert.clip_from_params(jax.tree_util.tree_map(np.asarray, params),
                                    clip_vit.get_clip_config("test-tiny"))
    return params["visual"], cfg.vision, port.visual


@pytest.mark.parametrize("normalize", [True, False])
def test_clip_encode_image_bf16_matches_jax_patch_kernel(tiny_vision, monkeypatch, normalize):
    """The port's bf16 forward routes uint8 images through the patch-embed
    wrapper and agrees with the JAX forward through its Pallas kernel."""
    params, cfg, visual = tiny_vision
    imgs = np.random.default_rng(11).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    monkeypatch.setenv("CLIPCAP_PATCH_KERNEL", "1")
    want = np.asarray(jclip.clip_encode_image(params, cfg, jnp.asarray(imgs), dtype=jnp.bfloat16,
                                              normalize_pixels=normalize), np.float32)
    with mock.patch.object(clip_vit, "patch_embed", wraps=clip_vit.patch_embed) as spy:
        got = clip_vit.clip_encode_image(visual, torch.from_numpy(imgs), dtype=torch.bfloat16,
                                         normalize_pixels=normalize)
        assert spy.call_count == 1
        clip_vit.clip_encode_image(visual, torch.from_numpy(imgs), normalize_pixels=normalize)
        clip_vit.clip_encode_image(visual, torch.from_numpy(imgs).float() / 255,
                                   dtype=torch.bfloat16, normalize_pixels=normalize)
        assert spy.call_count == 1                   # fp32 and float images: eager path
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=0.02 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The CLI against the JAX package's
# ---------------------------------------------------------------------------


def _image_bytes(rng, size, fmt="PNG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _files_dataset(path: Path, n=6):
    rng = np.random.default_rng(0)
    path.mkdir()
    for i in range(n):
        (path / f"sample_{i:03d}.png").write_bytes(_image_bytes(rng, (48, 40 + 8 * (i % 2))))
        (path / f"sample_{i:03d}.txt").write_text(f"a tiny test image number {i}")
    return str(path)


def _tar_add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _webdataset(path: Path, shards=2, per_shard=3):
    rng = np.random.default_rng(1)
    path.mkdir()
    idx = 0
    for s in range(shards):
        with tarfile.open(path / f"shard-{s:04d}.tar", "w") as tar:
            for _ in range(per_shard):
                _tar_add(tar, f"{idx:06d}.jpg", _image_bytes(rng, (48, 48), "JPEG"))
                _tar_add(tar, f"{idx:06d}.json",
                         json.dumps({"caption": f"wds caption {idx}"}).encode())
                idx += 1
    return str(path / ("shard-{0000..%04d}.tar" % (shards - 1)))


def _port_args(argv):
    return add_encoder_args(add_preprocess_args(ArgumentParser())).parse_args(argv)


def _jax_args(argv):
    return jadd_encoder_args(jadd_preprocess_args(ArgumentParser())).parse_args(argv)


def _read_dataset(root: Path):
    files = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    embeds = {f: np.load(root / f) for f in files if f.endswith(".npy")}
    captions = {f: pd.read_parquet(root / f) for f in files if f.endswith(".parquet")}
    return files, embeds, captions, yaml.safe_load((root / "encoder_config.yaml").read_text())


CASES = {
    "files": (["--input-format", "files"], 6, 32),
    "files-2-partitions": (["--input-format", "files", "--output-partition-count", "2"], 6, 32),
    "webdataset": (["--input-format", "webdataset", "--wds-caption-key", "json/caption"], 6, 32),
    "windowed": (["--input-format", "files", "--use-windowed-embeddings", "true",
                  "--window-size", "4"], 6, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_writes_the_jax_dataset(tmp_path, case):
    """The same inputs through both packages' preprocess (test-tiny, bf16):
    the same files, captions frames and YAML; embeddings within
    0.02·max|ref|."""
    flags, n, dim = CASES[case]
    data = (_webdataset(tmp_path / "wds") if case == "webdataset"
            else _files_dataset(tmp_path / "raw"))
    common = ["--input-dataset", data, "--batch-size", "4", "--workers", "2",
              "--encoder-model-variant", "test-tiny", *flags]
    assert jpreprocess(_jax_args([*common, "--output-folder", str(tmp_path / "jax")])) == 0
    assert preprocess(_port_args([*common, "--output-folder", str(tmp_path / "port"),
                                  "--device", "cpu"])) == 0
    files, embeds, captions, config = _read_dataset(tmp_path / "port")
    jfiles, jembeds, jcaptions, jconfig = _read_dataset(tmp_path / "jax")
    assert files == jfiles
    assert config == jconfig and config["encoder_embedding_size"] == dim
    for name, frame in captions.items():
        pd.testing.assert_frame_equal(frame, jcaptions[name])
    assert sum(len(f) for f in captions.values()) == n
    for name, e in embeds.items():
        want = jembeds[name]
        assert e.dtype == np.float32 and e.shape == want.shape and np.isfinite(e).all()
        np.testing.assert_allclose(e, want, rtol=0, atol=0.02 * np.abs(want).max())
    if case == "files-2-partitions":
        assert [f for f in files if f.endswith(".npy")] == ["embeddings/embeds_0.npy",
                                                            "embeddings/embeds_1.npy"]
        assert list(captions["captions/captions_1.parquet"]["caption"]) == [
            f"a tiny test image number {i}" for i in (1, 3, 5)]
    if case == "windowed":
        assert embeds["embeddings/embeds_0.npy"].shape == (n, 5, dim)


def test_args_parse_as_the_jax_package_does():
    """Every flag, name and default, but ``--device``'s default."""
    argv = ["--input-dataset", "x", "--input-format", "webdataset", "--wds-caption-key",
            "json/caption", "--distribution-strategy", "pyspark", "--int8-encoder", "no",
            "--use-windowed-embeddings", "1", "--window-size", "9"]
    ours, theirs = vars(_port_args(argv)), vars(_jax_args(argv))
    assert (ours.pop("device"), theirs.pop("device")) == ("cuda", "tpu")
    assert ours == theirs


def test_sampler_and_braceexpand_match_jax():
    items = list(range(11))
    for i, n in ((0, 1), (0, 3), (2, 3), (4, 5)):
        assert Sampler(i, n)(items) == JSampler(i, n)(items) == items[i::n]
    for pattern in ("shard-{0000..0002}.tar", "{a,b}/x-{1..2}", "plain.tar",
                    "s3://b/{train,val}-{08..11}.tar", "{a,{b,c}}{1..3}", "x{1..2"):
        assert list(braceexpand(pattern)) == list(jbraceexpand(pattern))
    assert list(braceexpand("{a,{b,c}}-{8..10}"))[:4] == ["a-8", "a-9", "a-10", "b-8"]


def test_tar_key_split_ignores_dots_in_directories(tmp_path):
    shard = tmp_path / "shard.tar"
    with tarfile.open(shard, "w") as tar:
        for name in ("./0001.jpg", "./0001.txt", "imgs.v2/0002.jpg", "imgs.v2/0002.txt",
                     "0003.a.b", "noext"):
            _tar_add(tar, name, name.encode())
    got = list(reader.iterate_tar_samples(str(shard)))
    assert got == list(jreader.iterate_tar_samples(str(shard)))
    assert [sorted(s) for s in got] == [["__key__", "jpg", "txt"]] * 2 + [["__key__", "a.b"]]


def test_corrupt_image_and_bad_caption_warn_and_continue(tmp_path):
    data = _files_dataset(tmp_path / "raw", n=4)
    (tmp_path / "raw" / "sample_999.png").write_bytes(b"not an image at all")
    (tmp_path / "raw" / "sample_999.txt").write_text("caption of junk")
    out = tmp_path / "dataset"
    with pytest.warns(UserWarning, match="decode failed"):
        rc = preprocess(_port_args(["--input-dataset", data, "--output-folder", str(out),
                                    "--batch-size", "2", "--workers", "1", "--device", "cpu",
                                    "--encoder-model-variant", "test-tiny"]))
    assert rc == 0
    assert np.load(out / "embeddings" / "embeds_0.npy").shape == (4, 32)

    shard = tmp_path / "bad.tar"
    with tarfile.open(shard, "w") as tar:
        _tar_add(tar, "0.jpg", b"x")
        _tar_add(tar, "0.json", json.dumps({"caption": 3}).encode())
    wds = reader.WebdatasetReader(Sampler(0, 1), lambda raw: raw, [str(shard), "/missing.tar"],
                                  2, 1, wds_caption_key="json/caption")
    with pytest.warns(UserWarning) as caught:
        assert list(wds) == []
    assert {str(w.message).split(" ")[0] for w in caught} == {"caption", "shard"}


def test_what_is_not_ported_raises(tmp_path):
    """CLAP is ported: ``--encoder-model-name clap`` on a WAV runs (its
    numbers are held to the JAX package in tests/test_torch_clap.py); the
    card stays the default device."""
    import wave

    data = _files_dataset(tmp_path / "raw", n=1)
    with wave.open(str(tmp_path / "raw" / "sample_000.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(8000, "<i2").tobytes())
    argv = ["--input-dataset", data, "--output-folder", str(tmp_path / "out"),
            "--encoder-model-variant", "test-tiny"]
    assert preprocess(_port_args([*argv, "--device", "cpu", "--encoder-model-name", "clap",
                                  "--media-file-extensions", "wav"])) == 0
    assert np.load(tmp_path / "out" / "embeddings" / "embeds_0.npy").shape == (1, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            start_preprocess(argv)                   # --device cuda, the default


def test_multihost_distributor_stripes_by_rank(monkeypatch):
    ran = []
    run = distributor.get_distributor("pyspark", ran.append, 5)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    run()
    assert ran == [0, 1, 2, 3, 4]                    # no group: process 0 of 1
    ran.clear()
    with mock.patch("torch.distributed.is_initialized", return_value=True), \
            mock.patch("torch.distributed.get_rank", return_value=1), \
            mock.patch("torch.distributed.get_world_size", return_value=2):
        run()
    assert ran == [1, 3]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="A9"):
        run()


def test_port_written_dataset_trains_a_step(tmp_path, capsys):
    from clipcap_tpu_torch.train.train import start_training

    data = _files_dataset(tmp_path / "raw")
    out = tmp_path / "dataset"
    assert start_preprocess(["--input-dataset", data, "--output-folder", str(out),
                             "--batch-size", "4", "--device", "cpu",
                             "--encoder-model-variant", "test-tiny"]) == 0
    models = tmp_path / "models"
    assert start_training(["--device", "cpu", "--input-dataset", str(out), "--output-folder",
                           str(models), "--language-model", "gpt2-test", "--batch-size", "8",
                           "--epochs", "1", "--scheduler-warmup-steps", "1",
                           "--logging-frequency", "1", "--prefix-length", "4",
                           "--projection-length", "4", "--transformer-layers", "2",
                           "--transformer-attention-heads", "4"]) == 0
    log = capsys.readouterr().out
    assert "partition 0: 6 samples" in log and "step 1 loss" in log and "step 2" not in log
    assert (models / "clipcap_final.npz").exists()


# ---------------------------------------------------------------------------
# The kernel against its twin (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_case(B, H, W, P, D, offset, fill=None):
    ident = "-".join(map(str, (B, H, W, P, D, offset)))
    return pytest.param(B, H, W, P, D, offset, fill,
                        id=ident if fill is None else f"{ident}-all{fill}")


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("B,H,W,P,D,offset,fill", [_kernel_case(*g, 0) for g in GEOMETRIES] + [
    _kernel_case(3, 224, 224, 14, 1024, 0), _kernel_case(5, 224, 224, 32, 768, 0),
    # A batch that does not start 16-byte aligned takes the kernel's bytes
    # path (the producer's own loads instead of the copy engine).
    _kernel_case(3, 32, 48, 16, 64, 1), _kernel_case(2, 64, 96, 32, 64, 1),
    _kernel_case(3, 224, 224, 14, 1024, 1),
    # A width that ends inside the 256-column tile; 160 tiles of 128
    # patches x 256 columns, more than one round of the persistent grid.
    _kernel_case(2, 224, 224, 14, 320, 0), _kernel_case(40, 224, 224, 14, 320, 0),
    # 255 in every pixel: the top of the exact uint8 -> bf16 widening.
    _kernel_case(4, 224, 224, 14, 1024, 0, fill=255),
    _kernel_case(4, 224, 224, 32, 768, 0, fill=255),
    # An odd patch: the copy engine's span, and the bytes path.
    _kernel_case(2, 112, 112, 7, 64, 0), _kernel_case(2, 28, 28, 7, 64, 0),
    # ViT-L/14@336px: a tile's 6 patch rows fit in shared memory once, so
    # the pixel ring has one stage; M = 1,728 ends inside a tile; both paths.
    _kernel_case(3, 336, 336, 14, 1024, 0), _kernel_case(3, 336, 336, 14, 1024, 1)])
def test_patch_embed_kernel_matches_twin(cuda, B, H, W, P, D, offset, fill, with_bias):
    imgs, w, bias = _patch_inputs(B * P, B, H, W, P, D)
    if fill is not None:
        imgs[...] = fill
    flat = torch.empty(imgs.size + offset, dtype=torch.uint8, device=cuda)
    imgs = flat[offset:].view(imgs.shape).copy_(torch.from_numpy(imgs))
    w = w.to(cuda)
    # A bias the size of the outputs, so that dropping it fails clearly.
    bias = (bias * 50).to(cuda) if with_bias else None
    before = patch_embed.launches
    got = patch_embed(imgs, w, bias, P)
    want = patch_embed_ref(imgs, w, bias, P)
    torch.cuda.synchronize()
    assert patch_embed.launches == before + 1
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -7 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("P,path", [(14, 0), (16, RUNS)])
def test_patch_embed_entry_refuses_copy_engine_off_alignment(cuda, P, path):
    """Told to use the copy engine on a batch off 16 bytes, the C entry
    raises instead of faulting the copy."""
    from clipcap_tpu_torch.ops import _build
    flat = torch.zeros(3 * 224 * 224 * 3 + 1, dtype=torch.uint8, device=cuda)
    imgs = flat[1:].view(3, 224, 224, 3)
    w = torch.zeros(3 * P * P, 64, dtype=torch.bfloat16, device=cuda)
    out = torch.empty(3, (224 // P) ** 2, 64, dtype=torch.bfloat16, device=cuda)
    code = _build.load_library().clipcap_patch_embed(
        imgs.data_ptr(), w.data_ptr(), None, out.data_ptr(), 3, 224, 224, P, 64, path,
        _build.stream_of(imgs))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(code, "patch_embed")
    assert pixel_path(imgs.shape, P, imgs.data_ptr()) == path | BYTES


@pytest.mark.cuda
def test_clip_encode_image_bf16_launches_the_patch_kernel(cuda):
    # Two heads of 64 (sdpa_packed's head width on the card), 16-px patches.
    cfg = clip_vit.CLIPVisionConfig(image_size=32, patch_size=16, width=128, layers=2, heads=2,
                                    embed_dim=32)
    visual = clip_vit.VisionTransformer(cfg).to(cuda)
    with torch.no_grad():
        for p in visual.parameters():
            p.normal_(0.0, 0.02)
    imgs = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8, device=cuda)
    before = patch_embed.launches
    out = clip_vit.clip_encode_image(visual, imgs, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert patch_embed.launches == before + 1
    assert out.shape == (3, 32) and torch.isfinite(out.float()).all()
