"""The port's training path against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages, on the
tiny model of ``__graft_entry__._tiny_model`` (vocab 512, n_embd 64, 2
GPT-2 layers, a 2-layer mapper).  The JAX fused-AdamW kernel runs in
Pallas interpret mode on the CPU, as the JAX package's own tests run it;
the port's side is the kernel's plain twin, which is what a CPU tensor
reaches.  Unless a case says otherwise the tolerance is fp32 rtol 1e-5,
atol 1e-6: both sides do the same fp32 arithmetic, in another summation
order where a reduction is involved.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from clipcap_tpu.models import clipcap as jclipcap
from clipcap_tpu.train import checkpoint as jckpt
from clipcap_tpu.train import state as jstate
from clipcap_tpu.train.dataloader import EmbedDataset as JEmbedDataset
from clipcap_tpu.train.step import train_step as jtrain_step
from clipcap_tpu_torch.convert import clipcap_named, clipcap_tree
from clipcap_tpu_torch.models import clipcap as tclipcap
from clipcap_tpu_torch.models.gpt2 import GPT2Config as TGPT2Config
from clipcap_tpu_torch.ops.fused_adamw import adamw_scalars, fused_adamw, fused_adamw_ref
from clipcap_tpu_torch.train import checkpoint as tckpt
from clipcap_tpu_torch.train import state as tstate
from clipcap_tpu_torch.train.dataloader import get_dataloader
from clipcap_tpu_torch.train.step import train_step as ttrain_step

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import __graft_entry__ as ge  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """``{path: array}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else
                   {f"{prefix}{k}": np.asarray(v)})
    return out


def _assert_trees(got, want, **tol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or TOL))


def _models(full: bool):
    """The tiny JAX model and the port's, on the same weights."""
    jm = ge._tiny_model(train_language_model=full)
    c = jm.lm_config
    lm_cfg = TGPT2Config(vocab_size=c.vocab_size, n_positions=c.n_positions, n_embd=c.n_embd,
                         n_layer=c.n_layer, n_head=c.n_head, name=c.name)
    tm = tclipcap.model_from_params(jm.config, _np(jm.params), lm_config=lm_cfg)
    return jm, tm


def _batch(seed=1, n=6, T=20, vocab=512, dim=32):
    """Tokens with -1 pads of varied length (T = 20: a full and a partial
    16-position CE chunk), some real id-0 tokens, and embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(n, T)).astype(np.int32)
    tokens[:, 3] = 0                                   # id 0 ("!") is a real token
    for i, length in enumerate(rng.integers(1, T, size=n)):
        tokens[i, length:] = -1
    tokens[-1] = -1                                    # an all-pad row
    embeds = rng.normal(size=(n, dim)).astype(np.float32)
    return tokens, embeds


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 5, 20), (2e-5, 0, 0), (3e-4, 10, 4)])
def test_linear_warmup_decay_matches_jax(lr, warmup, total):
    want = jstate.linear_warmup_decay(lr, warmup, total)
    got = tstate.linear_warmup_decay(lr, warmup, total)
    steps = range(0, max(warmup, total) + 4)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], **TOL)


def _optimizer_pair(fused: bool, clip: float = 0.5):
    """Prefix-only AdamW with the schedule and a clip, in both packages."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, train_language_model=False,
              grad_clip_norm=clip)
    return jstate.make_optimizer(fused=fused, **kw), tstate.make_optimizer(fused=fused, **kw)


def _run_optimizers(jtx, ttx, n_steps=4):
    """``n_steps`` updates on the same random grads (large enough that the
    clip triggers) → the JAX state and the port's."""
    jm, tm = _models(full=False)
    jst = jstate.create_train_state(jm.params, jtx)
    tst = tstate.create_train_state(tm, ttx)
    rng = np.random.default_rng(0)
    jparams, jopt = jst.params, jst.opt_state
    update = jax.jit(jtx.update)
    for _ in range(n_steps):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), _np(jm.params))
        updates, jopt = update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        named = dict(tm.named_parameters())
        params = [named[n] for n in tst.opt_state.mu]
        tgrads = clipcap_named(tm, {"mapper": grads["mapper"]})
        ttx.update_(params, [tgrads[n] for n in tst.opt_state.mu], tst.opt_state)
    return _np(jparams), jopt, tm, tst


@pytest.mark.parametrize("fused", [True, False])
def test_adamw_matches_jax_optimizer(fused):
    """The port's AdamW — the fused kernel's twin (``fused``) or the plain
    optax-order ops — against the JAX optimizer of the same flag, over 4
    scheduled, clipped, prefix-only steps: params and both moments."""
    jtx, ttx = _optimizer_pair(fused)
    jparams, jopt, tm, tst = _run_optimizers(jtx, ttx)
    assert tst.opt_state.count == 4
    _assert_trees(tm.params(), jparams)
    inner = jopt.inner_states["train"].inner_state[1]       # chain(clip, adamw)
    adam = inner if fused else inner[0]
    for name, want in (("mu", adam.mu), ("nu", adam.nu)):
        got = clipcap_tree(tm, getattr(tst.opt_state, name))
        assert set(got) == {"mapper"}                        # the LM has no moments
        _assert_trees(got["mapper"], _np(want["mapper"]))


def test_fused_twin_params_match_optax_adamw():
    """The fused twin against ``optax.adamw`` itself (the JAX package's
    default optimizer): the same parameters.  The moments differ by design
    in the last bits: the fused kernels take ``1 - b`` in float32 from the
    float32 ``b``, optax in double."""
    jtx, _ = _optimizer_pair(fused=False)
    _, ttx = _optimizer_pair(fused=True)
    jparams, _, tm, _ = _run_optimizers(jtx, ttx)
    _assert_trees(tm.params(), jparams)


def test_fused_adamw_wrapper_takes_the_twin_on_cpu():
    """On CPU tensors the wrapper is the twin, bit for bit, and launches
    nothing."""
    rng = np.random.default_rng(3)
    shapes = [(37,), (4, 128), (3, 5, 7), ()]
    make = lambda: [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    p, g, m = make(), make(), make()
    v = [x.abs() for x in make()]
    copies = [[t.clone() for t in group] for group in (p, g, m, v)]
    s = adamw_scalars(1e-3, 0.9, 0.999, 1e-8, 0.01, count=3)
    n0 = fused_adamw.launches
    fused_adamw(p, g, m, v, s)
    fused_adamw_ref(*copies, s)
    assert fused_adamw.launches == n0
    for a, b in zip(p + m + v, copies[0] + copies[2] + copies[3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full,remat", [(False, False), (True, True)])
def test_clipcap_loss_and_grads_match_jax(full, remat):
    jm, tm = _models(full)
    tokens, embeds = _batch()
    P = jm.config.prefix_length

    def jloss(params):
        return jclipcap.clipcap_loss(params, jm.lm_config, jm.mapper_config, P,
                                     jnp.asarray(tokens), jnp.asarray(embeds),
                                     dtype=jnp.float32, remat=remat, freeze_lm=not full)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jm.params)
    tx = tstate.make_optimizer(1e-3, 2, 10, train_language_model=full)
    st = tstate.create_train_state(tm, tx)
    named = dict(tm.named_parameters())
    params = [named[n] for n in st.opt_state.mu]
    loss = tclipcap.clipcap_loss(tm, torch.from_numpy(tokens), torch.from_numpy(embeds),
                                 dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(loss, params)
    assert not any(p.requires_grad for p in tm.language_model.parameters()) or full
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = clipcap_tree(tm, dict(zip(st.opt_state.mu, grads)))
    want = _np(want_grads)
    assert set(got) == ({"mapper", "lm"} if full else {"mapper"})
    # Grads sum over 6 rows × 30 positions in another order: 1e-5 of the
    # largest grad of each leaf covers it.
    for sub in got:
        for k, w in _leaves(want[sub]).items():
            g = _leaves(got[sub])[k]
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max() + 1e-7,
                                       err_msg=f"{sub}/{k}")
    if not full:                     # frozen LM: JAX's stop_gradient grads are zero
        assert all(not np.any(x) for x in _leaves(want["lm"]).values())


def test_clipcap_loss_counts_token_zero_and_ignores_pads():
    """A caption of token 0 alone has a loss; appending pads to the batch
    changes nothing."""
    _, tm = _models(full=False)
    emb = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32)).astype(np.float32))
    zero = tclipcap.clipcap_loss(tm, torch.tensor([[0, -1, -1]]), emb)
    assert torch.isfinite(zero) and zero.item() > 0
    padded = tclipcap.clipcap_loss(tm, torch.tensor([[0, -1, -1], [-1, -1, -1]]),
                                   torch.cat([emb, emb]))
    torch.testing.assert_close(padded, zero, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["prefix", "full"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_three_train_steps_match_jax(full, fused):
    """Params after three steps (lr 1e-3, warmup 2: lr 0, 5e-4, 1e-3).
    Adam normalises each grad by its running RMS, so a grad that the two
    packages sum in another order can move its parameter by up to ±lr per
    step where the grad is near zero; elsewhere the steps agree far closer.
    Bound, in units of Σlr = 1.5e-3: max |Δ| ≤ 0.01·Σlr and mean |Δ| ≤
    1e-5·Σlr over every parameter (measured on the CPU: max 1.8e-6, i.e.
    0.0012·Σlr, and mean 7e-10)."""
    jm, tm = _models(full)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, train_language_model=full,
              grad_clip_norm=1.0, fused=fused)
    jtx = jstate.make_optimizer(**kw)
    ttx = tstate.make_optimizer(**kw)
    jst = jstate.create_train_state(jm.params, jtx)
    tst = tstate.create_train_state(tm, ttx)
    step = jax.jit(lambda s, t, e: jtrain_step(
        s, t, e, tx=jtx, lm_cfg=jm.lm_config, mapper_cfg=jm.mapper_config,
        prefix_length=jm.config.prefix_length, dtype=jnp.float32, freeze_lm=not full))
    for seed in range(3):
        tokens, embeds = _batch(seed)
        jst, metrics = step(jst, jnp.asarray(tokens), jnp.asarray(embeds))
        loss = ttrain_step(tst, torch.from_numpy(tokens), torch.from_numpy(embeds), tx=ttx,
                           dtype=torch.float32)
        np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    assert tst.step == int(jst.step) == 3
    sum_lr = 0.0 + 5e-4 + 1e-3
    got, want = _leaves(tm.params()), _leaves(_np(jst.params))
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 0.01 * sum_lr and diffs.mean() <= 1e-5 * sum_lr, \
        (diffs.max(), diffs.mean())
    if not full:                     # the frozen LM has not moved, in either package
        _assert_trees(tm.params()["lm"], _np(jm.params["lm"]), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Train-state checkpoints across the packages
# ---------------------------------------------------------------------------


def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(7, np.int32) if np.ndim(x) == 0 and
                   np.asarray(x).dtype == np.int32 else
                   rng.normal(size=np.shape(x)).astype(np.float32)), tree)


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("full", [False, True], ids=["prefix", "full"])
def test_train_state_checkpoints_cross_packages(tmp_path, full, fused, clip):
    """For every optimizer layout: the port writes the JAX key set, shapes
    and dtypes; a JAX train state resumes in the port exactly; a port
    train state resumes in the JAX package exactly."""
    jm, tm = _models(full)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, train_language_model=full,
              grad_clip_norm=1.0 if clip else None, fused=fused)
    jtx, ttx = jstate.make_optimizer(**kw), tstate.make_optimizer(**kw)
    rng = np.random.default_rng(int(full) * 4 + int(fused) * 2 + int(clip))

    # JAX → port: random params and moments, counts 7.
    jst = jstate.create_train_state(jm.params, jtx)
    jst = jstate.TrainState(step=np.asarray(7, np.int32), params=_random_like(jst.params, rng),
                            opt_state=_random_like(jst.opt_state, rng))
    jckpt.save_train_state(str(tmp_path / "jax.npz"), jst)
    tst = tstate.create_train_state(tm, ttx)
    tckpt.save_train_state(str(tmp_path / "port0.npz"), tst, ttx)
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port0.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    tckpt.restore_train_state(str(tmp_path / "jax.npz"), tst, ttx)
    tckpt.save_train_state(str(tmp_path / "port.npz"), tst, ttx)
    assert tst.step == tst.opt_state.count == 7
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # port → JAX: move the port's state, save, restore in the JAX package.
    with torch.no_grad():
        for t in list(tst.opt_state.mu.values()) + list(tm.parameters()):
            t.add_(1.0)
    tst.step, tst.opt_state.count = 9, 9
    tckpt.save_train_state(str(tmp_path / "port9.npz"), tst, ttx)
    like = jstate.create_train_state(jm.params, jtx)
    back = jckpt.restore_train_state(str(tmp_path / "port9.npz"), like)
    jckpt.save_train_state(str(tmp_path / "jax9.npz"), back)
    assert int(back.step) == 9
    with np.load(tmp_path / "jax9.npz") as got, np.load(tmp_path / "port9.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Dataloader
# ---------------------------------------------------------------------------


class _Tokenizer:
    """Deterministic offline stand-in for GPT-2 BPE: one id per word."""

    def batch_encode_plus(self, texts):
        return {"input_ids": [[sum(map(ord, w)) % 500 for w in t.split()] for t in texts]}


def _write_dataset(root: Path, counts=(7, 5, 9), dim=16, windowed=False):
    """The dataset of ``tests/test_train.py``, with captions of 8 to 80
    words so that some are cut at 64 tokens."""
    import pandas as pd

    (root / "embeddings").mkdir(parents=True)
    (root / "captions").mkdir()
    rng = np.random.default_rng(0)
    total = 0
    for i, n in enumerate(counts):
        shape = (n, 3, dim) if windowed else (n, dim)
        np.save(root / "embeddings" / f"embeds_{i:03d}.npy",
                rng.normal(size=shape).astype(np.float32))
        caps = [" ".join(f"w{total + j}x{k}" for k in range(rng.integers(8, 81)))
                for j in range(n)]
        pd.DataFrame({"caption": caps}).to_parquet(root / "captions" / f"captions_{i:03d}.parquet")
        total += n
    with open(root / "encoder_config.yaml", "w") as f:
        yaml.safe_dump({"encoder_model_name": "clip", "encoder_model_variant": "test-tiny",
                        "encoder_embedding_size": dim}, f)
    return str(root) + "/"


@pytest.mark.parametrize("windowed", [False, True])
def test_dataloader_matches_jax(tmp_path, windowed):
    path = _write_dataset(tmp_path, windowed=windowed)
    kw = dict(batch_size=8, reader_max_piece_size=4, reader_parallel_pieces=2)
    want = list(JEmbedDataset(path, tokenizer=_Tokenizer(), **kw))
    loader, emb_size = get_dataloader(path, tokenizer=_Tokenizer(), **kw)
    got = list(loader)
    assert emb_size == 16 and len(loader) == len(got) == len(want) == 3
    for (gt, ge_), (wt, we) in zip(got, want):
        assert gt.shape == (8, 64) and gt.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge_, we)
    tokens = np.concatenate([t for t, _ in got])
    assert (tokens[21:] == -1).all()                          # the padded final batch
    assert (tokens[:21, -1] != -1).any() and (tokens[:21, -1] == -1).any()   # cut at 64


def test_prefetch_loader_stops_its_thread_when_left_early(tmp_path):
    import threading

    path = _write_dataset(tmp_path, counts=(40,))
    loader, _ = get_dataloader(path, batch_size=2, tokenizer=_Tokenizer())
    before = threading.active_count()
    for _ in loader:
        break
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

_CLI = ["--language-model", "gpt2-test", "--batch-size", "8", "--epochs", "1",
        "--scheduler-warmup-steps", "1", "--logging-frequency", "1",
        "--prefix-length", "4", "--projection-length", "4",
        "--transformer-layers", "2", "--transformer-attention-heads", "4",
        "--train-language-model", "true", "--fused-optimizer", "true"]


def test_train_cli_fresh_interpreter_without_jax(tmp_path):
    """``python -m clipcap_tpu_torch.train --device cpu``, resuming from a
    train state the JAX package wrote: it loads no JAX, writes the three
    files, and its final checkpoint loads in both packages' ``load``."""
    from clipcap_tpu.config import Config, EncoderConfig

    data = _write_dataset(tmp_path / "data")
    # The JAX package's train state for the model and optimizer the CLI
    # builds, at step 3.
    config = Config(language_model="gpt2-test", train_language_model=True, prefix_length=4,
                    projection_length=4, transformer_layers=2, transformer_attention_heads=4,
                    encoder_config=EncoderConfig(encoder_embedding_size=16))
    jtx = jstate.make_optimizer(2e-5, 1, 3, train_language_model=True, fused=True)
    jst = jstate.create_train_state(jclipcap.init_clipcap(config).params, jtx)
    jst = jst._replace(step=np.asarray(3, np.int32),
                       opt_state=jst.opt_state._replace(count=np.asarray(3, np.int32)))
    jckpt.save_train_state(str(tmp_path / "jax_state.npz"), jst)

    out = tmp_path / "models"
    argv = ["train", "--device", "cpu", "--input-dataset", data, "--output-folder", str(out),
            "--resume-from", str(tmp_path / "jax_state.npz"), *_CLI]
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('clipcap_tpu_torch.train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert 'jax' not in sys.modules, 'the port loaded jax'\n"
        "print('NO-JAX')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO-JAX" in res.stdout and "resumed from" in res.stdout and "at step 3" in res.stdout
    assert sorted(os.listdir(out)) == ["clipcap_config.yaml", "clipcap_epoch_0.npz",
                                       "clipcap_final.npz"]
    final, yaml_path = str(out / "clipcap_final.npz"), str(out / "clipcap_config.yaml")
    with np.load(final) as z:
        assert int(z["step"]) == int(z["opt_state::count"]) == 3 + 3

    jmodel, _ = jclipcap.load(final, yaml_path)
    tmodel, _ = tclipcap.load(final, yaml_path, device="cpu")
    _assert_trees(tmodel.params(), _np(jmodel.params), rtol=0, atol=0)
    assert jmodel.config.training_config.total_steps == 3


@pytest.mark.parametrize("flags,error", [
    (["--device", "0,1"], NotImplementedError),
    (["--device", "cpu", "--mesh-model", "2"], NotImplementedError),
    (["--device", "cpu", "--deepspeed-strategy", "deepspeed_stage_3"], SystemExit),
    (["--device", "0"], RuntimeError),
])
def test_train_cli_rejects_what_is_not_ported(flags, error):
    """Several devices, tensor parallelism and ZeRO 2/3 raise before any
    data is read; without CUDA only an explicit ``cpu`` trains."""
    from argparse import ArgumentParser

    from clipcap_tpu.models.args import add_model_args
    from clipcap_tpu_torch.train.args import add_training_args
    from clipcap_tpu_torch.train.train import train

    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    parser = add_model_args(add_training_args(ArgumentParser()))
    args = parser.parse_args(["--input-dataset", "/nonexistent/", *flags])
    with pytest.raises(error):
        train(args)


# ---------------------------------------------------------------------------
# The kernel against its twin (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fused_adamw_kernel_matches_twin_bit_for_bit(cuda):
    """Aligned and misaligned tensors, ragged sizes, one launch per step;
    every operation is rounded on its own in both, so they agree exactly."""
    g = torch.Generator(device=cuda).manual_seed(0)
    sizes = [1, 3, 5, 37, 4096, 4097, 4099, 100_000, 589_825]
    groups = []
    for k in range(4):
        group = []
        for i, n in enumerate(sizes):
            off = int(i % 3 == k % 3)                 # some 4-byte-offset (unaligned) views
            t = torch.randn(n + off, generator=g, device=cuda)[off:]
            group.append(t.abs() * 1e-3 if k == 3 else t)
        groups.append(group)
    twin = [[t.clone() for t in group] for group in groups]
    n0 = fused_adamw.launches
    for count in (1, 2, 3):
        s = adamw_scalars(1e-3 * count, 0.9, 0.999, 1e-8, 0.01, count)
        fused_adamw(*groups, s)
        fused_adamw_ref(*twin, s)
    torch.cuda.synchronize()
    assert fused_adamw.launches == n0 + 3
    for i in (0, 2, 3):
        for a, b in zip(groups[i], twin[i]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_adamw_launches_on_its_tensors_stream_and_device(cuda):
    """The kernel runs on the current stream of its tensors' device (the
    last visible card), ordered after the work queued there before it: the
    grads are written on a side stream behind a ~30 ms spin, and the
    update still sees them."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    g = torch.Generator(device=dev).manual_seed(1)
    p, want_g, m = (torch.randn(300_001, generator=g, device=dev) for _ in range(3))
    v = torch.rand(300_001, generator=g, device=dev) * 1e-3
    twin = [[t.clone()] for t in (p, want_g, m, v)]
    grads = torch.zeros_like(want_g)
    s = adamw_scalars(1e-3, 0.9, 0.999, 1e-8, 0.01, 1)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    n0 = fused_adamw.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        grads.copy_(want_g)
        fused_adamw([p], [grads], [m], [v], s)
    side.synchronize()
    fused_adamw_ref(*twin, s)
    torch.cuda.synchronize(dev)
    assert fused_adamw.launches == n0 + 1
    for a, b in zip((p, m, v), (twin[0][0], twin[2][0], twin[3][0])):
        assert torch.equal(a, b)
