"""The port's CLIP ResNet towers (RN50 family) against the JAX package's,
on the CPU.

Weights are the JAX package's seeded trees, turned into the port's modules
by ``clipcap_tpu_torch.convert``, or an OpenAI-format ``.pt`` with
non-trivial batch-norm statistics written with ``torch.save``; images are
made with numpy from a seed.  Tolerances: fp32 towers within 1e-4 of the
reference's norm (‖d‖/‖ref‖; JAX at ``Precision.HIGHEST``: fp32 rounding in
another summation order over a few convolution layers); bf16 forwards
within 0.02·max|ref|, the tolerance the ViT's bf16 forwards are held to
(tests/test_torch_preprocess.py): the two frameworks round to bf16 at
other places.
"""
import dataclasses
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from clipcap_tpu.encoders import base as jencoders
from clipcap_tpu.encoders.args import add_encoder_args as jadd_encoder_args
from clipcap_tpu.encoders.clip import get_clip_encoder as jget_clip_encoder
from clipcap_tpu.models import clip_resnet as jresnet
from clipcap_tpu.models import clip_vit as jclip
from clipcap_tpu.preprocess.args import add_preprocess_args as jadd_preprocess_args
from clipcap_tpu.preprocess.preprocess import preprocess as jpreprocess
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.encoders import base as encoders
from clipcap_tpu_torch.encoders.args import add_encoder_args
from clipcap_tpu_torch.encoders.clip import get_clip_encoder
from clipcap_tpu_torch.models import clip_resnet, clip_vit
from clipcap_tpu_torch.preprocess.args import add_preprocess_args
from clipcap_tpu_torch.preprocess.preprocess import preprocess

torch.set_num_threads(1)
HIGHEST = jax.lax.Precision.HIGHEST
# test-tiny-rn (one block a stage) and a tower of two blocks a stage (the
# stacked tail of identical blocks).
DEEP = clip_vit._preset_rn("deep-rn", image_size=64, width=16, layers=(2, 2, 2, 2), embed=32,
                           twidth=64, tlayers=2, theads=4)
CONFIGS = {"test-tiny-rn": clip_vit.RN_PRESETS["test-tiny-rn"], "deep-rn": DEEP}


def _jcfg(cfg: clip_vit.CLIPConfig) -> jclip.CLIPConfig:
    return jclip.CLIPConfig(name=cfg.name,
                            vision=jresnet.CLIPResNetConfig(**dataclasses.asdict(cfg.vision)),
                            text=jclip.CLIPTextConfig(**dataclasses.asdict(cfg.text)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, value in items:
        if isinstance(value, (dict, list)):
            yield from _leaves(value, f"{prefix}{key}/")
        elif value is not None:
            yield f"{prefix}{key}", np.asarray(value)


def _assert_trees_close(got, want, rtol=0.0):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0, err_msg=key)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(seed, n=3, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def rn(request):
    cfg = CONFIGS[request.param]
    params = jclip.init_clip(_jcfg(cfg), seed=0)
    return params, _jcfg(cfg), convert.clip_from_params(_np_tree(params), cfg)


def test_presets_equal_jax():
    """Every RN preset's vision and text config, and the names served."""
    jrn = jclip._rn_presets()
    assert sorted(clip_vit.RN_PRESETS) == sorted(jrn)
    for name, cfg in clip_vit.RN_PRESETS.items():
        want = jclip.get_clip_config(name)
        assert cfg == clip_vit.get_clip_config(name) and cfg.name == want.name == name
        assert dataclasses.asdict(cfg.vision) == dataclasses.asdict(want.vision), name
        assert dataclasses.asdict(cfg.text) == dataclasses.asdict(want.text), name
        assert cfg.vision.grid == want.vision.grid and cfg.vision.pool_width == \
            want.vision.pool_width
        assert cfg.text.width // cfg.text.heads == 64 or name == "test-tiny-rn"
    with pytest.raises(ValueError, match="RN50x64"):
        clip_vit.get_clip_config("RN51")


def test_init_draws_equal_jax():
    for cfg in CONFIGS.values():
        _assert_trees_close(clip_resnet.init_clip_resnet(cfg.vision, seed=4),
                            _np_tree(jresnet.init_clip_resnet(_jcfg(cfg).vision, seed=4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(rn, dtype):
    params, jcfg, port = rn
    imgs = _images(1)
    want = np.asarray(jclip.clip_encode_image(params["visual"], jcfg.vision, jnp.asarray(imgs),
                                              dtype=getattr(jnp, dtype), precision=HIGHEST),
                      np.float32)
    got = clip_vit.clip_encode_image(port.visual, torch.from_numpy(imgs),
                                     dtype=getattr(torch, dtype)).float().numpy()
    assert got.shape == want.shape == (3, jcfg.vision.embed_dim)
    if dtype == "float32":
        assert _rel(got, want) < 1e-4
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
    x = imgs.astype(np.float32) / 255.0                       # float input, no normalisation
    want = jresnet.clip_encode_image_resnet(params["visual"], jcfg.vision, jnp.asarray(x),
                                            precision=HIGHEST, normalize_pixels=False)
    got = clip_resnet.clip_encode_image_resnet(port.visual, torch.from_numpy(x),
                                               normalize_pixels=False)
    assert _rel(got, want) < 1e-4


def test_tree_module_tree_is_the_identity(rn):
    params, _, port = rn
    _assert_trees_close(convert.resnet_params(port.visual), _np_tree(params["visual"]))
    visual = convert.resnet_from_params(_np_tree(params["visual"]), port.config.vision)
    assert all(m.eps == 0.0 for m in visual.modules()
               if isinstance(m, clip_resnet.BatchNorm))


def _openai_checkpoint(port, path, seed):
    """``port``'s OpenAI state dict in fp16 with seeded batch-norm
    statistics and affines (and the non-weight entries real ones carry)."""
    rng = np.random.default_rng(seed)
    sd = {k: v.half() for k, v in port.state_dict().items()}
    for name, m in port.named_modules():
        if isinstance(m, clip_resnet.BatchNorm):
            n = len(m.weight)
            for key, draw in (("weight", rng.uniform(0.5, 1.5, n)), ("bias", rng.normal(0, .1, n)),
                              ("running_mean", rng.normal(0, .1, n)),
                              ("running_var", rng.uniform(0.5, 1.5, n))):
                sd[f"{name}.{key}"] = torch.from_numpy(draw.astype(np.float16))
            sd[f"{name}.num_batches_tracked"] = torch.tensor(100)
    sd["input_resolution"] = torch.tensor(port.config.vision.image_size)
    torch.save(sd, path)


def test_openai_checkpoint_loads_alike_in_both_packages(rn, tmp_path, monkeypatch):
    """An OpenAI-format RN ``.pt`` through both loaders: the same config and
    folded tree, forwards within 1e-4; the port's state dict through the JAX
    importer gives the same forward."""
    params, jcfg, port = rn
    path = tmp_path / "rn.pt"
    _openai_checkpoint(port, path, seed=2)
    loaded, cfg = clip_vit.load_clip("RN50", checkpoint_path=str(path))
    jparams, jloaded_cfg = jclip.load_clip("RN50", checkpoint_path=str(path))
    assert cfg.name == jloaded_cfg.name and cfg.vision.layers == jcfg.vision.layers
    assert dataclasses.asdict(cfg.vision) == dataclasses.asdict(jloaded_cfg.vision)
    assert all(m.eps == 1e-5 for m in loaded.modules() if isinstance(m, clip_resnet.BatchNorm))
    _assert_trees_close(convert.resnet_params(loaded.visual), _np_tree(jparams["visual"]),
                        rtol=1e-6)
    imgs = _images(3)
    got = clip_vit.clip_encode_image(loaded.visual, torch.from_numpy(imgs))
    want = jclip.clip_encode_image(jparams["visual"], jloaded_cfg.vision, jnp.asarray(imgs),
                                   precision=HIGHEST)
    assert _rel(got, want) < 1e-4
    sd = loaded.state_dict()
    imported = jclip.clip_params_from_openai(sd, jclip.clip_config_from_openai(sd))
    again = jclip.clip_encode_image(imported["visual"], jloaded_cfg.vision, jnp.asarray(imgs),
                                    precision=HIGHEST)
    assert _rel(got, again) < 1e-4
    np.testing.assert_array_equal(
        clip_resnet.resnet_params_from_openai(sd, cfg.vision)["attnpool"]["c_proj"]["w"],
        np.asarray(imported["visual"]["attnpool"]["c_proj"]["w"]))

    monkeypatch.setenv("CLIPCAP_CLIP_CHECKPOINT", str(path))
    encoder, transform = get_clip_encoder("RN50", device="cpu", dtype=torch.float32)
    assert encoder.config.vision == cfg.vision and transform.n_px == cfg.vision.image_size


@pytest.mark.parametrize("windowed", [False, True])
def test_encoder_and_rerank_match_jax(windowed, tmp_path):
    """``CLIPEncoder`` at test-tiny-rn in fp32 (plain and windowed, 4
    tiles) and its rerank through the causal text tower."""
    from PIL import Image

    path = tmp_path / "img.png"
    Image.fromarray(_images(5, n=1, size=80)[0]).save(path)
    kw = dict(use_windowed_embeddings=windowed, window_size=4)
    encoder, transform = get_clip_encoder("test-tiny-rn", device="cpu", dtype=torch.float32,
                                          **kw)
    jencoder, jtransform = jget_clip_encoder("test-tiny-rn", dtype=jnp.float32, **kw)
    sample = transform(str(path))
    np.testing.assert_array_equal(sample, jtransform(str(path)))
    assert sample.shape == ((5, 64, 64, 3) if windowed else (64, 64, 3))
    got, want = encoder(sample[None]), jencoder(sample[None])
    assert got.shape == want.shape and _rel(got, want) < 1e-4
    captions = ["a photo of a cat", "a diagram", "noise on a screen"]
    np.testing.assert_allclose(encoder.similarity(sample, captions),
                               jencoder.similarity(sample, captions), rtol=1e-4, atol=1e-4)


def test_int8_is_refused_as_in_jax(rn):
    _, _, port = rn
    with pytest.raises(ValueError, match="ViT-only"):
        encoders.get_encoder("clip", "test-tiny-rn", device="cpu", int8=True)
    with pytest.raises(ValueError, match="ViT-only"):
        jencoders.get_encoder("clip", "test-tiny-rn", int8=True)
    with pytest.raises(ValueError, match="ViT-only"):
        clip_vit.clip_encode_image(port.visual, torch.from_numpy(_images(0, n=1)),
                                   int8_acts=True)


def test_rn50_serves_at_its_width():
    """``get_encoder("clip", "RN50")`` on the CPU: seeded weights (with the
    JAX package's warning), 224 px, one finite [1, 1024] embedding; the
    module's tensors have the JAX tree's shapes."""
    with pytest.warns(UserWarning, match="RANDOM"):
        encoder, transform = encoders.get_encoder("clip", "RN50", device="cpu")
    assert transform.n_px == 224 and encoder.embedding_size == 1024
    out = encoder(_images(6, n=1, size=224))
    assert out.shape == (1, 1024) and np.isfinite(out).all()
    shapes = {k: v.shape for k, v in _leaves(convert.resnet_params(encoder.model.visual))}
    want = jresnet.init_clip_resnet(jclip.get_clip_config("RN50").vision)
    assert shapes == {k: v.shape for k, v in _leaves(want)}


def test_preprocess_writes_the_jax_dataset(tmp_path):
    """Images through both packages' preprocess at test-tiny-rn (bf16, each
    package's default): the same captions, embeddings within 0.02·max|ref|."""
    from PIL import Image

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(7)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (72, 64 + 8 * i, 3), dtype=np.uint8)).save(
            raw / f"s{i}.png")
        (raw / f"s{i}.txt").write_text(f"an image number {i}")
    common = ["--input-dataset", str(raw), "--batch-size", "2", "--workers", "2",
              "--encoder-model-variant", "test-tiny-rn"]
    assert jpreprocess(jadd_encoder_args(jadd_preprocess_args(ArgumentParser())).parse_args(
        [*common, "--output-folder", str(tmp_path / "jax")])) == 0
    assert preprocess(add_encoder_args(add_preprocess_args(ArgumentParser())).parse_args(
        [*common, "--output-folder", str(tmp_path / "port"), "--device", "cpu"])) == 0
    got = np.load(tmp_path / "port" / "embeddings" / "embeds_0.npy")
    want = np.load(tmp_path / "jax" / "embeddings" / "embeds_0.npy")
    assert got.shape == want.shape == (5, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
    pd.testing.assert_frame_equal(
        pd.read_parquet(tmp_path / "port" / "captions" / "captions_0.parquet"),
        pd.read_parquet(tmp_path / "jax" / "captions" / "captions_0.parquet"))
