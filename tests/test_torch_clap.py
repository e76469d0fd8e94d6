"""The port's CLAP audio stack against the JAX package's, on the CPU.

Covered: the host audio functions (bit for bit: they are the same numpy),
the log-mel frontend, the JAX bicubic resize of ``reshape_wav2img`` (the
``HTSAT-tiny`` time upsample and ``test-tiny``'s antialiased 2-D
downsample), the HTSAT forward (``test-tiny``, and a depths-(2, 2) config
whose blocks shift their windows), the fusion forward, the RoBERTa text
tower with padded rows, the rerank, the weights carried both ways and
through laion_clap-format ``.pt`` files, and the preprocess, inference and
eval stages on WAV files.

Weights are the JAX package's seeded trees, turned into the port's modules
by ``clipcap_tpu_torch.convert``; inputs are made with numpy from a seed.
Tolerances, in fp32 (JAX at ``Precision.HIGHEST``): the log-mel within
1e-3 dB (an rFFT of 1,024 points in another order, then 10·log10); the
resize within 1e-5·max|ref| (two products of at most 1,001 terms); towers
within 1e-4 of the reference's norm (‖d‖/‖ref‖: a few layers of fp32
rounding in another summation order); the text tower and the rerank within
1e-5.  The hash fallback of the RoBERTa tokenizer salts its ids per
process (ROADMAP C8), so both packages tokenise here, in one process.
"""
import contextlib
import dataclasses
import io
import json
import sys
import wave
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

from clipcap_tpu.config import Config, EncoderConfig, save_yaml_config
from clipcap_tpu.encoders import base as jencoders
from clipcap_tpu.encoders.args import add_encoder_args as jadd_encoder_args
from clipcap_tpu.encoders.clap import get_clap_encoder as jget_clap_encoder
from clipcap_tpu.eval import base as jeval
from clipcap_tpu.eval.args import add_eval_args as jadd_eval_args
from clipcap_tpu.inference import demo as jdemo
from clipcap_tpu.inference.args import add_inference_args as jadd_inference_args
from clipcap_tpu.models import clipcap as jclipcap
from clipcap_tpu.models import htsat as jhtsat
from clipcap_tpu.models import roberta as jroberta
from clipcap_tpu.models.gpt2 import GPT2_PRESETS
from clipcap_tpu.ops import audio as jaudio
from clipcap_tpu.preprocess.args import add_preprocess_args as jadd_preprocess_args
from clipcap_tpu.preprocess.preprocess import preprocess as jpreprocess
from clipcap_tpu.train.checkpoint import save_params as jsave_params
from clipcap_tpu.utils import roberta_tokenizer as jrt
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.encoders import base as encoders
from clipcap_tpu_torch.encoders.args import add_encoder_args
from clipcap_tpu_torch.encoders.clap import get_clap_encoder
from clipcap_tpu_torch.eval import base as teval
from clipcap_tpu_torch.inference import demo
from clipcap_tpu_torch.inference.args import add_inference_args
from clipcap_tpu_torch.models import htsat, roberta
from clipcap_tpu_torch.ops import audio
from clipcap_tpu_torch.preprocess.args import add_preprocess_args
from clipcap_tpu_torch.preprocess.preprocess import preprocess
from clipcap_tpu_torch.utils import roberta_tokenizer as rt
from clipcap_tpu_torch.utils.tokenizer import bytes_to_unicode

torch.set_num_threads(1)
HIGHEST = jax.lax.Precision.HIGHEST
SR = audio.CLAP_SAMPLE_RATE
TINY = htsat.CLAP_PRESETS["test-tiny"]
# Two stages of two blocks: the second block of each shifts its windows
# (16×16 and 8×8 token grids under 4×4 windows).
SHIFTED = htsat.HTSATConfig(spec_size=64, embed_dim=16, depths=(2, 2), heads=(2, 4),
                            window_size=4, latent_dim=32, embedding_dim=16, name="shifted")
CONFIGS = {"test-tiny": TINY, "shifted": SHIFTED}


def _jcfg(cfg: htsat.HTSATConfig) -> jhtsat.HTSATConfig:
    return jhtsat.HTSATConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(jhtsat.HTSATConfig)})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, value in items:
        if isinstance(value, (dict, list)):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    """int16 PCM WAV of ``samples`` [frames] or [frames, channels] in [-1, 1]."""
    data = samples if samples.ndim == 2 else samples[:, None]
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _noise(seed: int, seconds: float, rate: int = SR, channels: int = 0) -> np.ndarray:
    n = int(seconds * rate)
    shape = (n, channels) if channels else (n,)
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def tower(request):
    """A seeded JAX tree, its config, and the port's module of the same weights."""
    cfg = CONFIGS[request.param]
    params = jhtsat.init_htsat(_jcfg(cfg), seed=3)
    return params, _jcfg(cfg), convert.htsat_from_params(_np_tree(params), cfg)


# ---------------------------------------------------------------------------
# Host audio functions: the same numpy, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels,rate", [(1, 16000), (2, 44100), (1, 48000)])
def test_load_audio_and_to_mono_equal_jax(channels, rate):
    data = _wav_bytes(_noise(channels, 0.25, rate, channels=channels), rate)
    got, got_rate = audio.load_audio(data)
    want, want_rate = jaudio.load_audio(data)
    assert got_rate == want_rate == rate and got.shape == (rate // 4, channels)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio.to_mono(got), jaudio.to_mono(want))


@pytest.mark.parametrize("orig,target", [(44100, 48000), (16000, 48000), (48000, 16000),
                                         (48000, 48000)])
def test_resample_equals_jax(orig, target):
    x = _noise(5, 0.3, orig)
    got = audio.resample(x, orig, target)
    np.testing.assert_array_equal(got, jaudio.resample(x, orig, target))
    assert abs(len(got) - int(0.3 * target)) <= 1


def test_mel_filterbank_and_log_mel_numpy_equal_jax():
    np.testing.assert_array_equal(audio.mel_filterbank(), jaudio.mel_filterbank())
    np.testing.assert_array_equal(audio.mel_filterbank(16000, 512, 40, 0.0, 8000.0),
                                  jaudio.mel_filterbank(16000, 512, 40, 0.0, 8000.0))
    x = _noise(6, 1.5)
    np.testing.assert_array_equal(audio.log_mel_numpy(x), jaudio.log_mel_numpy(x))


@pytest.mark.parametrize("seconds", [3.0, 10.0, 25.0])
def test_build_mel_fusion_equals_jax(seconds):
    """Short audio (padded, four equal channels), exactly 10 s, and long
    audio (the shrunk whole and three chunks)."""
    x = _noise(7, seconds)
    got = audio.build_mel_fusion(x)
    np.testing.assert_array_equal(got, jaudio.build_mel_fusion(x))
    assert got.shape == (4, audio.CLAP_CHUNK_FRAMES, 64)
    assert (seconds > 10) == bool(np.any(got[1] != got[0]))
    np.testing.assert_array_equal(audio._resize_bilinear_frames(got[1], 700),
                                  jaudio._resize_bilinear_frames(got[1], 700))


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------


def test_log_mel_spectrogram_matches_jax():
    """Within 1e-3 dB; a silent row sits at the 1e-10 floor (-100 dB) in
    both."""
    x = np.stack([_noise(8, 10.0), np.zeros(10 * SR, np.float32), _noise(9, 10.0) * 0.01])
    got = audio.log_mel_spectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(x)))
    assert got.shape == want.shape == (3, audio.CLAP_CHUNK_FRAMES, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    floor = want == -100.0
    assert floor[1].all() and (got[floor] == -100.0).all()


@pytest.mark.parametrize("name", ["HTSAT-tiny", "test-tiny"])
def test_reshape_wav2img_is_the_jax_bicubic(name):
    """HTSAT-tiny upsamples time (1001 → 1024 frames); test-tiny also
    downsamples frequency (64 → 16 bins: the antialiased kernel).
    PyTorch's own bicubic (a = -0.75, clamped edges, no antialias) differs
    by ~0.26 here."""
    cfg = htsat.CLAP_PRESETS[name]
    x = np.random.default_rng(10).standard_normal((2, 1, 1001, 64)).astype(np.float32)
    got = htsat.reshape_wav2img(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jhtsat.reshape_wav2img(jnp.asarray(x), _jcfg(cfg)))
    assert got.shape == want.shape == (2, 1, cfg.spec_size, cfg.spec_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    w = htsat.resize_weights(1001, cfg.spec_size * cfg.freq_ratio)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-5)


def test_swin_pieces_equal_jax():
    for ws in (4, 8):
        np.testing.assert_array_equal(htsat._rel_position_index(ws),
                                      jhtsat._rel_position_index(ws))
    for H, ws, shift in ((16, 4, 2), (8, 4, 2), (64, 8, 4)):
        np.testing.assert_array_equal(htsat._shift_mask(H, H, ws, shift),
                                      jhtsat._shift_mask(H, H, ws, shift))
    x = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    w = htsat._window_partition(x, 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jhtsat._window_partition(
        jnp.asarray(x.numpy()), 4)))
    assert torch.equal(htsat._window_reverse(w, 4, 8, 8), x)


def test_htsat_forward_matches_jax(tower):
    """``htsat_latent`` on mels and ``clap_audio_embedding`` on waveforms
    shorter and longer than 10 s (padded and cut)."""
    params, jcfg, module = tower
    mel = np.random.default_rng(11).standard_normal((2, 1001, 64)).astype(np.float32) * 10 - 40
    with mock.patch.object(htsat, "_swin_block", wraps=htsat._swin_block) as spy:
        got = htsat.htsat_latent(module.audio_branch, torch.from_numpy(mel))
    shifts = [c.args[6] for c in spy.call_args_list]
    assert (max(shifts) > 0) == (jcfg.name == "shifted")
    want = jhtsat.htsat_latent(params, jcfg, jnp.asarray(mel), precision=HIGHEST)
    assert got.shape == want.shape == (2, jcfg.latent_dim)
    assert _rel(got, want) < 1e-4

    wav = [_noise(12, 4.0), _noise(13, 12.0)]
    for w in wav:
        x = np.stack([w, -0.5 * w])
        got = htsat.clap_audio_embedding(module, torch.from_numpy(x))
        want = jhtsat.clap_audio_embedding(params, jcfg, jnp.asarray(x), precision=HIGHEST)
        assert got.shape == want.shape == (2, jcfg.embedding_dim)
        assert _rel(got, want) < 1e-4


@pytest.fixture(scope="module")
def fusion_tower():
    cfg = dataclasses.replace(_jcfg(TINY), enable_fusion=True)
    params = jhtsat.init_htsat(cfg, seed=4)
    module = convert.htsat_from_params(_np_tree(params), dataclasses.replace(
        TINY, enable_fusion=True))
    return params, cfg, module


def test_fusion_forward_matches_jax(fusion_tower):
    """A short clip (four equal channels: AFF bypassed, the plain forward's
    latent) beside a 25 s clip (AFF over the three chunks) in one batch."""
    params, jcfg, module = fusion_tower
    short, long = (audio.build_mel_fusion(_noise(s, sec)) for s, sec in ((14, 6.0), (15, 25.0)))
    x = np.stack([short, long])
    got = htsat.htsat_latent_fusion(module.audio_branch, torch.from_numpy(x))
    want = jhtsat.htsat_latent_fusion(params, jcfg, jnp.asarray(x), precision=HIGHEST)
    assert _rel(got[1], want[1]) < 1e-4 and _rel(got[0], want[0]) < 1e-4
    plain = htsat.htsat_latent(module.audio_branch, torch.from_numpy(short[:1]))
    torch.testing.assert_close(got[:1], plain, rtol=1e-6, atol=1e-6)
    emb = htsat.clap_audio_embedding_fusion(module, torch.from_numpy(x))
    jemb = jhtsat.clap_audio_embedding_fusion(params, jcfg, jnp.asarray(x), precision=HIGHEST)
    assert _rel(emb, jemb) < 1e-4


# ---------------------------------------------------------------------------
# The text tower and the rerank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def text_tower():
    tree, cfg = jhtsat.init_clap_text(16)
    jrcfg = jroberta.RobertaConfig(**{f.name: getattr(cfg, f.name) for f in
                                      dataclasses.fields(jroberta.RobertaConfig)})
    port_cfg = roberta.RobertaConfig(**dataclasses.asdict(cfg))
    return tree, jrcfg, convert.clap_text_from_params(_np_tree(tree), port_cfg)


def test_roberta_and_text_embedding_match_jax(text_tower):
    """Rows of 77 ids padded after 3, 10 and 77 real tokens."""
    tree, cfg, module = text_tower
    rng = np.random.default_rng(16)
    ids = rng.integers(3, cfg.vocab_size, (3, 77)).astype(np.int32)
    mask = np.zeros((3, 77), np.int32)
    for i, n in enumerate((3, 10, 77)):
        mask[i, :n] = 1
        ids[i, n:] = rt.PAD
    ids[:, 0] = rt.BOS
    hidden, pooled = roberta.roberta_apply(module.text_branch, torch.from_numpy(ids),
                                           torch.from_numpy(mask))
    jhidden, jpooled = jroberta.roberta_apply(tree["roberta"], cfg, jnp.asarray(ids),
                                              jnp.asarray(mask), precision=HIGHEST)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=0, atol=1e-5)
    got = htsat.clap_text_embedding(module, torch.from_numpy(ids), torch.from_numpy(mask))
    want = jhtsat.clap_text_embedding(tree, cfg, jnp.asarray(ids), jnp.asarray(mask),
                                      precision=HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # No mask: RoBERTa's own (ids != pad).
    _, pooled2 = roberta.roberta_apply(module.text_branch, torch.from_numpy(ids))
    torch.testing.assert_close(pooled2, pooled, rtol=0, atol=0)


def _bpe_files(path: Path, captions):
    """A seeded RoBERTa-format vocab.json/merges.txt: the special tokens,
    the 256 byte symbols, merges of the captions' frequent pairs, and
    GPT-2's end-of-text entry."""
    symbols = list(bytes_to_unicode().values())
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({s: 4 + i for i, s in enumerate(symbols)})
    enc = bytes_to_unicode()
    words = {"".join(enc[b] for b in (" " + w).encode()) for c in captions for w in c.split()}
    merges = []
    for word in sorted(words):
        for a, b in zip(word, word[1:3]):
            if (a, b) not in merges:
                merges.append((a, b))
    merges = merges[:40]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(path)


CAPTIONS = ["a dog barks twice", "rain falls on a tin roof", "someone speaks",
            "music plays in the distance while a car passes by"]


@pytest.mark.parametrize("tokenizer", ["hash", "bpe"])
def test_rerank_similarity_matches_jax(tokenizer, tmp_path, monkeypatch):
    """``CLAPEncoder.similarity`` (test-tiny, its seeded tiny text tower) on
    one clip against four captions, with ids from the hash fallback (one
    process) or from BPE files through ``$CLIPCAP_ROBERTA_TOKENIZER``."""
    monkeypatch.setattr(rt, "_resolved", None)
    monkeypatch.setattr(jrt, "_resolved", None)
    if tokenizer == "bpe":
        monkeypatch.setenv("CLIPCAP_ROBERTA_TOKENIZER", _bpe_files(tmp_path / "tok", CAPTIONS))
    else:
        monkeypatch.delenv("CLIPCAP_ROBERTA_TOKENIZER", raising=False)
        monkeypatch.setitem(sys.modules, "transformers", None)   # no cached roberta-base
    ids, mask = rt.roberta_tokenize(CAPTIONS, vocab_size=1024)
    jids, jmask = jrt.roberta_tokenize(CAPTIONS, vocab_size=1024)
    assert rt._resolved[0] == jrt._resolved[0] == tokenizer
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)

    encoder, transform = get_clap_encoder("test-tiny", device="cpu")
    jencoder, jtransform = jget_clap_encoder("test-tiny")
    clip = _wav_bytes(_noise(17, 2.0, 44100, channels=2), 44100)
    sample = transform(io.BytesIO(clip))
    np.testing.assert_array_equal(sample, jtransform(io.BytesIO(clip)))
    got = encoder.similarity(sample, CAPTIONS)
    want = jencoder.similarity(sample, CAPTIONS)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(encoder(sample[None]), jencoder(sample[None]), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Weights both ways, and laion_clap-format files
# ---------------------------------------------------------------------------


def test_weights_carry_both_ways(tower, fusion_tower, text_tower):
    """JAX tree → port module → tree is the identity; the port's state dict
    through the JAX importers gives the JAX tree, whose forward equals the
    port's."""
    for params, jcfg, module in (tower, fusion_tower):
        _assert_trees_equal(convert.htsat_params(module), _np_tree(params))
        imported = jhtsat.htsat_params_from_laion_clap(module.state_dict(), jcfg)
        _assert_trees_equal(_np_tree(imported), _np_tree(params))
    tree, cfg, text = text_tower
    _assert_trees_equal(convert.clap_text_params(text), _np_tree(tree))
    # The JAX importer reads a width-64 tower as 8 heads; give the port's
    # module the same, from the same weights.
    text = convert.clap_text_from_params(_np_tree(tree), dataclasses.replace(text.config,
                                                                             num_heads=8))
    jtext, jcfg = jhtsat.clap_text_params_from_laion_clap(text.state_dict())
    assert jcfg.num_heads == 8
    _assert_trees_equal(_np_tree(jtext), _np_tree(tree))
    ids = np.full((2, 77), rt.PAD, np.int32)
    ids[0, :5] = [0, 7, 8, 9, 2]
    ids[1, :3] = [0, 500, 2]
    got = htsat.clap_text_embedding(text, torch.from_numpy(ids))
    want = jhtsat.clap_text_embedding(jtext, jcfg, jnp.asarray(ids), precision=HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    sd = text.state_dict()
    _assert_trees_equal(roberta.roberta_params_from_hf(sd, text.config, "text_branch."),
                        _np_tree(jroberta.roberta_params_from_hf(sd, jcfg, "text_branch.")))


@pytest.mark.parametrize("fusion", [False, True])
def test_laion_clap_checkpoint_loads_alike_in_both_packages(fusion, tmp_path, monkeypatch):
    """A laion_clap-format ``.pt`` (``state_dict`` under ``module.`` keys,
    audio and text halves, extra buffers) written with ``torch.save`` from
    seeded trees with non-trivial batch-norm statistics: both packages'
    ``load_clap`` read the same weights (fusion recognised by
    ``mel_conv2d``) and embed a clip and captions alike."""
    cfg = dataclasses.replace(TINY, name="tiny-checkpoint", enable_fusion=fusion)
    monkeypatch.setitem(htsat.CLAP_PRESETS, cfg.name, dataclasses.replace(
        cfg, enable_fusion=False))
    monkeypatch.setitem(jhtsat.CLAP_PRESETS, cfg.name, dataclasses.replace(
        _jcfg(cfg), enable_fusion=False))
    tree = _np_tree(jhtsat.init_htsat(_jcfg(cfg), seed=5))
    rng = np.random.default_rng(18)
    tree["bn0"]["mean"] = rng.standard_normal(64).astype(np.float32)
    tree["bn0"]["var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    audio_module = convert.htsat_from_params(tree, cfg)
    text_tree, rcfg = htsat.init_clap_text(16, seed=2)
    rcfg = dataclasses.replace(rcfg, num_heads=8)   # what a checkpoint of width 64 reads
    text_module = convert.clap_text_from_params(text_tree, rcfg)
    sd = {**audio_module.state_dict(), **text_module.state_dict(),
          "audio_branch.bn0.num_batches_tracked": torch.tensor(7),
          "logit_scale_a": torch.tensor(2.0)}
    path = tmp_path / "clap.pt"
    torch.save({"epoch": 3, "state_dict": {"module." + k: v for k, v in sd.items()}}, path)

    got_audio, got_cfg, (got_text, got_rcfg) = htsat.load_clap(cfg.name, str(path))
    want, want_cfg, (want_text, want_rcfg) = jhtsat.load_clap(cfg.name, str(path))
    assert got_cfg.enable_fusion == want_cfg.enable_fusion == fusion
    assert got_rcfg.num_heads == want_rcfg.num_heads == 8
    _assert_trees_equal(convert.htsat_params(got_audio), _np_tree(want))
    _assert_trees_equal(convert.clap_text_params(got_text), _np_tree(want_text))

    monkeypatch.setenv("CLIPCAP_CLAP_CHECKPOINT", str(path))
    encoder, transform = get_clap_encoder(cfg.name, device="cpu")
    jencoder, jtransform = jget_clap_encoder(cfg.name)
    clip = _wav_bytes(_noise(19, 14.0), SR)
    sample = transform(io.BytesIO(clip))
    assert sample.shape == ((4, 1001, 64) if fusion else (10 * SR,))
    np.testing.assert_array_equal(sample, jtransform(io.BytesIO(clip)))
    assert _rel(encoder(sample[None]), jencoder(sample[None])) < 1e-4
    monkeypatch.setattr(rt, "_resolved", ("hash", None))
    monkeypatch.setattr(jrt, "_resolved", ("hash", None))
    np.testing.assert_allclose(encoder.encode_text(CAPTIONS), jencoder.encode_text(CAPTIONS),
                               rtol=0, atol=1e-5)


def test_int8_encoder_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="CLIP-only"):
        encoders.get_encoder("clap", "HTSAT-tiny", device="cpu", int8=True)
    with pytest.raises(ValueError, match="CLIP-only"):
        jencoders.get_encoder("clap", "HTSAT-tiny", int8=True)


def test_unknown_variant_is_htsat_tiny_and_the_card_is_the_default(monkeypatch):
    """The CLI's variant flag defaults to a CLIP name: CLAP serves
    HTSAT-tiny for it (seeded here, with the JAX package's warning)."""
    monkeypatch.delenv("CLIPCAP_CLAP_CHECKPOINT", raising=False)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        encoder, transform = get_clap_encoder("ViT-B/32", device="cpu")
    assert encoder.config == htsat.CLAP_PRESETS["HTSAT-tiny"] and encoder.embedding_size == 512
    assert not transform.enable_fusion
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_clap_encoder("test-tiny")


# ---------------------------------------------------------------------------
# The stages on WAV files
# ---------------------------------------------------------------------------


def _wav_dataset(path: Path, n: int = 5) -> str:
    """Clips of 2 to 12 s, mono and stereo, at 16, 44.1 and 48 kHz, with
    ``.txt`` captions."""
    path.mkdir()
    for i in range(n):
        rate = (16000, 44100, 48000)[i % 3]
        data = _noise(20 + i, 2.0 + 2.5 * i, rate, channels=1 + i % 2)
        (path / f"clip_{i:03d}.wav").write_bytes(_wav_bytes(data, rate))
        (path / f"clip_{i:03d}.txt").write_text(f"a tiny test sound number {i}")
    return str(path)


def _args(add_enc, add_pre, argv):
    return add_enc(add_pre(ArgumentParser())).parse_args(argv)


def test_preprocess_writes_the_jax_dataset(tmp_path):
    """WAVs through both packages' preprocess with ``--encoder-model-name
    clap`` (test-tiny): the same captions and YAML, embeddings within 1e-4
    of the reference's norm."""
    data = _wav_dataset(tmp_path / "raw")
    common = ["--input-dataset", data, "--batch-size", "2", "--workers", "2",
              "--encoder-model-name", "clap", "--encoder-model-variant", "test-tiny",
              "--media-file-extensions", "wav"]
    assert jpreprocess(_args(jadd_encoder_args, jadd_preprocess_args,
                             [*common, "--output-folder", str(tmp_path / "jax")])) == 0
    assert preprocess(_args(add_encoder_args, add_preprocess_args,
                            [*common, "--output-folder", str(tmp_path / "port"),
                             "--device", "cpu"])) == 0
    got = np.load(tmp_path / "port" / "embeddings" / "embeds_0.npy")
    want = np.load(tmp_path / "jax" / "embeddings" / "embeds_0.npy")
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 16)
    assert _rel(got, want) < 1e-4
    pd.testing.assert_frame_equal(
        pd.read_parquet(tmp_path / "port" / "captions" / "captions_0.parquet"),
        pd.read_parquet(tmp_path / "jax" / "captions" / "captions_0.parquet"))
    config = yaml.safe_load((tmp_path / "port" / "encoder_config.yaml").read_text())
    assert config == yaml.safe_load((tmp_path / "jax" / "encoder_config.yaml").read_text())
    assert config["encoder_model_name"] == "clap" and config["encoder_embedding_size"] == 16


@pytest.fixture(scope="module")
def audio_checkpoint(tmp_path_factory):
    """A seeded test-tiny CLAP captioner written by the JAX package, WAV
    files and a reference CSV."""
    d = tmp_path_factory.mktemp("clap_ckpt")
    config = Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_model_name="clap",
                                                 encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=16))
    model = jclipcap.init_clipcap(config, lm_config=GPT2_PRESETS["gpt2-test"], seed=3)
    jsave_params(str(d / "model.npz"), model.params)
    save_yaml_config(config, str(d / "config.yaml"))
    clips = Path(_wav_dataset(d / "clips", n=3))
    for txt in clips.glob("*.txt"):
        txt.unlink()
    pd.DataFrame([{"file_name": f"clip_{i:03d}.wav", **{f"cap_{j}": f"a sound {i} number {j}"
                                                         for j in range(1, 6)}}
                  for i in range(3)]).to_csv(d / "refs.csv", index=False)
    return d


def test_inference_cli_captions_a_wav_as_jax(audio_checkpoint):
    """Both inference CLIs on one ``.wav`` at ``--top-k 1``: the same
    candidates, similarities within 1e-5, the same best caption."""
    d = audio_checkpoint
    argv = ["--model-path", str(d / "model.npz"), "--config-path", str(d / "config.yaml"),
            "--sample-path", str(d / "clips" / "clip_001.wav"), "--number-to-generate", "2",
            "--top-k", "1"]
    outs = []
    for run, parser, extra in ((jdemo.inference_demo, jadd_inference_args(ArgumentParser()), []),
                               (demo.inference_demo, add_inference_args(ArgumentParser()),
                                ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(parser.parse_args(argv + extra)) == 0
        lines = buf.getvalue().splitlines()
        outs.append(([ln.split(" caption ", 1)[1] for ln in lines if ln.startswith("sim ")],
                     [float(ln.split()[1]) for ln in lines if ln.startswith("sim ")],
                     [ln for ln in lines if ln.startswith("best")]))
    (jcaps, jsims, jbest), (caps, sims, best) = outs
    assert caps == jcaps and len(caps) == 2
    np.testing.assert_allclose(sims, jsims, rtol=0, atol=1e-5)
    assert best == jbest and len(best) == 1


def test_eval_on_wavs_predicts_as_jax(audio_checkpoint, tmp_path):
    d = audio_checkpoint
    argv = ["--model-path", str(d / "model.npz"), "--config-path", str(d / "config.yaml"),
            "--sample-path", str(d / "clips"), "--reference-csv", str(d / "refs.csv"),
            "--csv-filename-column", "file_name", "--csv-reference-caption-columns",
            "cap_{1..5}", "--eval-batch-size", "2", "--number-to-generate", "2",
            "--top-k", "1", "--allow-fallback-tokenizer"]
    jout, out = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    out.mkdir()
    jparser = jadd_inference_args(jadd_eval_args(ArgumentParser()))
    assert jeval.eval(jparser.parse_args(argv + ["--save-predictions",
                                                 str(jout / "p.json")])) == 0
    assert teval.run_eval(argv + ["--save-predictions", str(out / "p.json"),
                                  "--device", "cpu"]) == 0
    preds = json.loads((out / "p.json").read_text())
    assert set(preds) == {f"clip_{i:03d}.wav" for i in range(3)}
    assert preds == json.loads((jout / "p.json").read_text())
