"""The port's small stages and tools against the JAX package's: finetune,
init, the three utils (export_checkpoint, merge_preprocessed_datasets,
scoring) and the profiling helpers; and the METEOR scorer's caches.

Inputs are written by the port and fed to both packages' functions: the
files written and the values returned must be equal.  ``init`` never
touches the network here: ``urllib.request.urlretrieve`` is stubbed in
every test that runs it.
"""
import gzip
import io
import os
import sys
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from clipcap_tpu.init import base as jinit
from clipcap_tpu.utils import export_checkpoint as jexport
from clipcap_tpu.utils import merge_preprocessed_datasets as jmerge
from clipcap_tpu.utils import scoring as jscoring
from clipcap_tpu_torch import config as tconfig
from clipcap_tpu_torch.init import base as tinit
from clipcap_tpu_torch.preprocess.writer import PartitionWriter, write_encoder_config
from clipcap_tpu_torch.utils import export_checkpoint, merge_preprocessed_datasets, scoring

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_files(got_root: Path, want_root: Path):
    got, want = _files(got_root), _files(want_root)
    assert got.keys() == want.keys()
    for name, path in want.items():
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got[name]), np.load(path), err_msg=name)
        elif name.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(got[name]), pd.read_parquet(path))
        else:
            assert got[name].read_bytes() == path.read_bytes(), name


def _port_dataset(root: Path, seed: int, parts, dim=16, variant="test-tiny"):
    """A dataset in the preprocess layout, written by the port's writer."""
    rng = np.random.default_rng(seed)
    write_encoder_config(tconfig.EncoderConfig(encoder_model_variant=variant,
                                               encoder_embedding_size=dim), str(root))
    for i, n in enumerate(parts):
        writer = PartitionWriter(i, str(root), len(parts))
        writer({"embeddings": rng.standard_normal((n, dim)).astype(np.float32),
                "text": [f"dataset {seed} caption {i}.{j}" for j in range(n)]})
        writer.flush()
    return str(root)


@pytest.mark.parametrize("move", [False, True])
def test_merge_writes_what_the_jax_merge_writes(tmp_path, move):
    """Eleven partitions over three datasets: renumbered 00-10 in order."""
    outs = {}
    for name, merge in (("port", merge_preprocessed_datasets.merge_datasets),
                        ("jax", jmerge.merge_datasets)):
        folders = [_port_dataset(tmp_path / name / f"in_{k}", k, parts)
                   for k, parts in enumerate(((3, 2), (4,) * 7, (1, 5)))]
        outs[name] = tmp_path / name / "merged"
        assert merge(folders, str(outs[name]), move=move) == 0
        left = sum(len(os.listdir(Path(f) / "embeddings")) for f in folders)
        assert left == (0 if move else 11)
    _assert_same_files(outs["port"], outs["jax"])
    names = sorted(os.listdir(outs["port"] / "embeddings"))
    assert names[0] == "embeds_00.npy" and names[-1] == "embeds_10.npy"


def test_merge_refuses_datasets_of_different_encoders(tmp_path):
    a = _port_dataset(tmp_path / "a", 0, (2,))
    b = _port_dataset(tmp_path / "b", 1, (2,), variant="ViT-B/32")
    for merge in (merge_preprocessed_datasets.merge_datasets, jmerge.merge_datasets):
        with pytest.raises(ValueError, match="mismatch"):
            merge([a, b], str(tmp_path / "out"))
    assert merge_preprocessed_datasets.main(["--folders", a, a, "--output-folder",
                                             str(tmp_path / "twice")]) == 0
    assert len(os.listdir(tmp_path / "twice" / "captions")) == 2


def _tiny_config():
    return tconfig.Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                          transformer_layers=2, transformer_attention_heads=2,
                          encoder_config=tconfig.EncoderConfig(encoder_model_variant="test-tiny",
                                                               encoder_embedding_size=16))


def test_export_writes_what_the_jax_export_writes(tmp_path):
    """A full train state written by the port (step, params, AdamW moments
    under the JAX key paths) cut to its parameters by both packages; an
    already params-only file passes through."""
    from clipcap_tpu_torch.models.clipcap import init_clipcap
    from clipcap_tpu_torch.models.gpt2 import get_gpt2_config
    from clipcap_tpu_torch.train.checkpoint import save_train_state
    from clipcap_tpu_torch.train.state import create_train_state, make_optimizer

    model = init_clipcap(_tiny_config(), lm_config=get_gpt2_config("gpt2-test"), seed=1)
    tx = make_optimizer(1e-4, 1, 10, train_language_model=True, fused=False)
    save_train_state(str(tmp_path / "state.npz"), create_train_state(model, tx), tx)
    full = dict(np.load(tmp_path / "state.npz"))
    assert any(k.startswith("opt_state::") for k in full) and "step" in full
    for name, export in (("port", export_checkpoint.export_params),
                         ("jax", jexport.export_params)):
        assert export(str(tmp_path / "state.npz"), str(tmp_path / f"{name}.npz")) == 0
        assert export(str(tmp_path / f"{name}.npz"), str(tmp_path / f"{name}_again.npz")) == 0
    got, want = dict(np.load(tmp_path / "port.npz")), dict(np.load(tmp_path / "jax.npz"))
    assert got.keys() == want.keys() == {k[len("params::"):] for k in full
                                         if k.startswith("params::")}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(np.load(tmp_path / "port_again.npz")[key], want[key])
    with pytest.raises(NotImplementedError, match="A14"):
        export_checkpoint.export_params(str(tmp_path / "orbax_dir"), str(tmp_path / "x.npz"))


def test_generate_scores_equal_jax():
    gts = {0: ["a man rides a horse on the beach", "a person on a horse"],
           1: [{"caption": "two dogs play in the park"}, {"caption": "dogs in a park"}],
           2: ["a red car parked next to a tree", "a car by a tree"]}
    res = {0: ["a man riding a horse"], 1: ["two dogs playing in a park"],
           2: ["a red sofa next to a tree"]}
    got, want = scoring.generate_scores(gts, res), jscoring.generate_scores(gts, res)
    assert [o["method"] for o in got] == [o["method"] for o in want] == [
        "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"]
    for g, w in zip(got, want):
        assert g["score"] == w["score"], g["method"]
        if g["method"] == "SPICE":
            assert [s["All"]["f"] for s in g["scores"]] == [s["All"]["f"] for s in w["scores"]]
        else:
            np.testing.assert_array_equal(np.asarray(g["scores"]), np.asarray(w["scores"]))


def _fake_jar() -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("edu/cmu/meteor/function/en.words", "the\na\nof\n")
        z.writestr("edu/cmu/meteor/synonym/english.synsets", "dog 1\nhound 1\n")
        z.writestr("edu/cmu/meteor/synonym/english.exceptions", "dogs dog\n")
        z.writestr("edu/cmu/meteor/other/readme.txt", "not extracted")
    return buf.getvalue()


def test_init_fetches_the_jax_assets_to_the_ports_readers(tmp_path, monkeypatch, capsys):
    """Every asset of the JAX init, each fetched to where the port reads it:
    OpenAI CLIP's shared cache, else the port's own; the jar's resources
    are extracted where the port's METEOR looks.  Nothing is fetched."""
    from clipcap_tpu_torch.eval import meteor

    fetched = []

    def urlretrieve(url, dest):
        fetched.append((url, dest))
        Path(dest).write_bytes(_fake_jar() if dest.endswith(".jar") else b"asset")

    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(tinit.urllib.request, "urlretrieve", urlretrieve)
    assert tinit.ASSETS.keys() == jinit.ASSETS.keys()
    assert tinit.init() == 0
    assert [u for u, _ in fetched] == [u for u, _ in jinit.ASSETS.values()]
    for (name, (_, dest)), (_, got) in zip(tinit.ASSETS.items(), fetched):
        assert got == os.path.expanduser(dest)
        root = ".cache/clip/" if name.startswith("clip") else ".cache/clipcap_tpu_torch/"
        assert got.startswith(str(home / root)), got
    mdir = home / ".cache" / "clipcap_tpu_torch" / "meteor"
    assert sorted(os.listdir(mdir)) == ["en.words", "english.exceptions", "english.synsets",
                                        "meteor-1.5.jar", "paraphrase-en.gz"]
    assert meteor.default_function_words_path() == str(mdir / "en.words")
    assert meteor.default_synonym_paths() == (str(mdir / "english.synsets"),
                                              str(mdir / "english.exceptions"))
    assert not (home / ".cache" / "clipcap_tpu").exists()
    # A second run finds everything in place and fetches nothing.
    fetched.clear()
    assert tinit.init() == 0 and fetched == []
    assert "already present" in capsys.readouterr().out


def test_init_offline_skips_every_asset(tmp_path, monkeypatch, capsys):
    def offline(url, dest):
        raise OSError("no network")

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(tinit.urllib.request, "urlretrieve", offline)
    assert tinit.init() == 0
    out = capsys.readouterr().out
    assert out.count("skipped (no network)") == len(tinit.ASSETS)
    assert "No assets could be fetched" in out


def test_eval_scorers_keep_to_the_ports_cache(tmp_path, monkeypatch):
    """The METEOR scorer with ``HOME`` in a temporary directory: it reads a
    paraphrase table placed in the port's cache, writes only there, and
    never creates the JAX package's ``~/.cache/clipcap_tpu``."""
    from clipcap_tpu_torch.eval import meteor
    from clipcap_tpu_torch.eval.metrics import evaluate_metrics_from_lists

    monkeypatch.setenv("HOME", str(tmp_path))
    for var in ("CLIPCAP_METEOR_PARAPHRASE", "CLIPCAP_METEOR_FUNCTION_WORDS",
                "CLIPCAP_METEOR_SYNONYMS", "CLIPCAP_SPICE_MODEL_CACHE"):
        monkeypatch.delenv(var, raising=False)
    hyp, refs = "a zorblat on the grass", ["a quibbit on the grass"]
    without = meteor.get_meteor().score_segment(hyp, refs)
    mdir = tmp_path / ".cache" / "clipcap_tpu_torch" / "meteor"
    mdir.mkdir(parents=True, exist_ok=True)
    with gzip.open(mdir / "paraphrase-en.gz", "wt") as f:
        f.write("zorblat ||| quibbit\n")
    assert meteor.default_paraphrase_path() == str(mdir / "paraphrase-en.gz")
    assert meteor.get_meteor().score_segment(hyp, refs) > without
    scores, _ = evaluate_metrics_from_lists(["a zorblat on the grass", "two dogs"],
                                            [[refs[0]] * 5, ["two dogs run"] * 5])
    assert np.isfinite(scores["METEOR"]) and np.isfinite(scores["SPIDEr"])
    assert not (tmp_path / ".cache" / "clipcap_tpu").exists()
    assert {p.parent for p in (tmp_path / ".cache").rglob("*") if p.is_file()} <= {
        mdir, tmp_path / ".cache" / "clipcap_tpu_torch"}


def test_start_finetuning_appends_the_flag_as_jax_does(monkeypatch):
    import clipcap_tpu.train.train as jtrain
    import clipcap_tpu_torch.train.train as ttrain
    from clipcap_tpu.finetune import start_finetuning as jstart
    from clipcap_tpu_torch.finetune import start_finetuning

    seen = []
    monkeypatch.setattr(jtrain, "start_training", lambda: seen.append(sys.argv[1:]) or 0)
    monkeypatch.setattr(ttrain, "start_training", lambda argv: seen.append(argv) or 0)
    for argv in (["--epochs", "1"], ["--epochs", "1", "--train-language-model", "false"]):
        monkeypatch.setattr(sys, "argv", ["finetune", *argv])
        assert jstart() == 0 and start_finetuning(list(argv)) == 0
        monkeypatch.setattr(sys, "argv", ["finetune", *argv])
        assert start_finetuning() == 0                # argv from the command line
        assert seen[-3] == seen[-2] == seen[-1]
    assert seen[0] == ["--epochs", "1", "--train-language-model", "true"]
    assert seen[-1] == ["--epochs", "1", "--train-language-model", "false"]


def test_finetune_trains_the_lm_and_exports_a_model_that_loads(tmp_path, capsys):
    """``python -m clipcap_tpu_torch.finetune``'s function on a tiny dataset
    on the CPU: GPT-2's weights move, and the exported params-only file
    loads and captions."""
    from clipcap_tpu_torch import generate_beam, load
    from clipcap_tpu_torch.finetune import start_finetuning
    from clipcap_tpu_torch.models.hf_import import load_gpt2

    data = _port_dataset(tmp_path / "data", 0, (6, 6))
    out = tmp_path / "out"
    assert start_finetuning(["--device", "cpu", "--input-dataset", data, "--output-folder",
                             str(out), "--language-model", "gpt2-test", "--batch-size", "4",
                             "--epochs", "1", "--prefix-length", "4", "--projection-length",
                             "4", "--transformer-layers", "2",
                             "--transformer-attention-heads", "2"]) == 0
    assert export_checkpoint.main(["--checkpoint", str(out / "clipcap_final.npz"),
                                   "--output", str(tmp_path / "model.npz")]) == 0
    model, tokenizer = load(str(tmp_path / "model.npz"), str(out / "clipcap_config.yaml"),
                            device="cpu")
    assert model.config.train_language_model
    before = load_gpt2("gpt2-test").state_dict()
    after = model.language_model.state_dict()
    assert any(not torch.equal(after[k], before[k]) for k in before)
    prefix = model.transformer_mapper(np.zeros((1, 16), np.float32))
    assert len(generate_beam(model, tokenizer, prefix, number_to_generate=1,
                             entry_length=5)) == 1


def test_profiling_helpers(tmp_path):
    """As the JAX package's (``tests/test_utils.py``): ``timed``, ``Timer``
    with counts and reset, and ``trace`` + ``annotate`` writing a trace."""
    from clipcap_tpu_torch.utils.profiling import Timer, annotate, timed, trace

    r, dt = timed(lambda x: x * 2, torch.ones(8), rounds=3)
    assert float(r[0]) == 2.0 and dt >= 0.0
    t = Timer()
    for _ in range(2):
        with t.section("a"):
            pass
    assert t.counts["a"] == 2 and "a" in t.summary()
    t.reset()
    assert t.counts == {} and t.summary() == {}
    with trace(None):
        pass
    assert not any(tmp_path.iterdir())
    with trace(str(tmp_path)):
        with annotate("unit-test-region"):
            float(torch.ones(4).sum())
    traces = list(tmp_path.rglob("*.json"))
    assert traces and "unit-test-region" in traces[0].read_text()
