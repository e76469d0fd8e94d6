"""The port's eval stage (``python -m clipcap_tpu_torch.eval``) against the
JAX package's (``clipcap_tpu.eval``).

Both packages run their own eval function on the same inputs: a tiny
seeded checkpoint written by the JAX package (the ``test-tiny`` CLIP
encoder, the 8-to-2-layer mapper, ``gpt2-test``), a folder of seeded
images with one undecodable file, and a reference CSV with five captions
per image.  At ``--top-k 1`` in fp32 the sampled captions are the argmax
path, so the predictions must be equal, string for string, with the
tile-major cache and the manual-pipeline decode switched on or off (on the
CPU the decode attention is the kernels' twin either way; the switches
change the cache layout).  The scores of one predictions file must be
equal, number for number.
"""
import json
import os
import subprocess
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from clipcap_tpu.config import Config, EncoderConfig, save_yaml_config
from clipcap_tpu.eval import base as jbase
from clipcap_tpu.eval import spice_parser as jspice_parser
from clipcap_tpu.eval.args import add_eval_args as jadd_eval_args
from clipcap_tpu.inference.args import add_inference_args as jadd_inference_args
from clipcap_tpu.models import clipcap as jclipcap
from clipcap_tpu.models.gpt2 import GPT2_PRESETS
from clipcap_tpu.train.checkpoint import save_params as jsave_params
from clipcap_tpu_torch.eval import base
from clipcap_tpu_torch.eval import spice_parser

REPO = Path(__file__).resolve().parents[1]
SWITCHES = ("CLIPCAP_CACHE_TILE_MAJOR", "CLIPCAP_FLASH_MANUAL")


def _jax_parser():
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter)
    return jadd_inference_args(jadd_eval_args(parser))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Checkpoint, image folder (5 images, one non-image file) and CSV."""
    from PIL import Image

    d = tmp_path_factory.mktemp("eval")
    config = Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    model = jclipcap.init_clipcap(config, lm_config=GPT2_PRESETS["gpt2-test"], seed=3)
    jsave_params(str(d / "model.npz"), model.params)
    save_yaml_config(config, str(d / "config.yaml"))
    images = d / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 256, (40 + 4 * i, 48, 3), dtype=np.uint8)).save(
            images / name)
        rows.append({"file_name": name, **{f"cap_{j}": f"a small test picture {i} number {j}"
                                           for j in range(1, 6)}})
    (images / "notes.txt").write_text("not an image")
    pd.DataFrame(rows).to_csv(d / "refs.csv", index=False)
    return d


def _argv(d: Path, out: Path):
    return ["--model-path", str(d / "model.npz"), "--config-path", str(d / "config.yaml"),
            "--sample-path", str(d / "images"), "--reference-csv", str(d / "refs.csv"),
            "--csv-filename-column", "file_name", "--csv-reference-caption-columns",
            "cap_{1..5}", "--eval-batch-size", "2", "--number-to-generate", "2",
            "--top-k", "1", "--allow-fallback-tokenizer", "--save-predictions",
            str(out / "preds.json"), "--save-file", str(out / "scores.json")]


@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    """The JAX package's eval: predictions and scores."""
    out = tmp_path_factory.mktemp("jax_eval")
    assert jbase.eval(_jax_parser().parse_args(_argv(inputs, out))) == 0
    return (json.loads((out / "preds.json").read_text()),
            json.loads((out / "scores.json").read_text()))


@pytest.mark.parametrize("tile_major,manual", [("0", "0"), ("1", "0"), ("0", "1"),
                                               ("1", "1")])
def test_eval_predictions_equal_jax_at_top_k_1(inputs, jax_run, tmp_path, monkeypatch,
                                                tile_major, manual):
    monkeypatch.setenv(SWITCHES[0], tile_major)
    monkeypatch.setenv(SWITCHES[1], manual)
    assert base.run_eval(_argv(inputs, tmp_path) + ["--device", "cpu"]) == 0
    preds = json.loads((tmp_path / "preds.json").read_text())
    want_preds, want_scores = jax_run
    assert set(preds) == {f"img_{i}.png" for i in range(5)}
    assert preds == want_preds
    assert json.loads((tmp_path / "scores.json").read_text()) == want_scores


def test_eval_cli_in_a_fresh_interpreter(inputs, jax_run, tmp_path):
    """``python -m clipcap_tpu_torch.eval --device cpu`` with both switches
    on: exit 0, the JAX eval's predictions, and no JAX loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               OMP_NUM_THREADS="1", **{name: "1" for name in SWITCHES})
    env.pop("JAX_PLATFORMS", None)
    code = ("import runpy, sys; sys.argv = ['eval'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('clipcap_tpu_torch.eval', run_name='__main__')\n"
            "finally:\n"
            "    assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'clipcap_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", code, *_argv(inputs, tmp_path), "--device",
                          "cpu"], capture_output=True, text=True, env=env, cwd=str(REPO),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "warning: cannot decode" in res.stdout and "SPIDEr" in res.stdout
    assert json.loads((tmp_path / "preds.json").read_text()) == jax_run[0]


def test_scores_of_a_predictions_json_equal_jax(inputs, tmp_path):
    """Score-only mode: the same ``--predictions-json`` and CSV give the
    same ``--save-file`` from both packages (a missing prediction is
    skipped by both)."""
    preds = {f"img_{i}.png": text for i, text in enumerate(
        ["a small test picture 0 number 1", "a picture of a cat on a mat",
         "two dogs run across the grass", "a small picture"])}
    (tmp_path / "preds.json").write_text(json.dumps(preds))
    scores = {}
    for name, parse, run in (("jax", _jax_parser().parse_args, jbase.eval),
                             ("port", base.build_parser().parse_args, base.eval)):
        out = tmp_path / name
        out.mkdir()
        argv = _argv(inputs, out)
        argv[argv.index("--save-predictions") + 1] = str(out / "copy.json")
        assert run(parse(argv + ["--predictions-json", str(tmp_path / "preds.json")])) == 0
        scores[name] = json.loads((out / "scores.json").read_text())
    assert scores["port"] == scores["jax"]
    for key in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE", "SPIDEr"):
        assert key in scores["port"]


def test_parser_has_the_jax_flags_but_int8_weights_and_the_mesh():
    """Every flag of the JAX eval parser but the serving mesh; the name
    predates the port of ``--int8-weights``, which the parser now has."""
    def flags(parser):
        return {opt: action.default for action in parser._actions
                for opt in action.option_strings}

    ours, theirs = flags(base.build_parser()), flags(_jax_parser())
    assert set(theirs) - set(ours) == {"--mesh-data", "--mesh-model"}
    assert set(ours) == set(theirs) - {"--mesh-data", "--mesh-model"}
    assert "--int8-weights" in ours                  # ported since ROADMAP A13
    assert ours.pop("--device") == "cuda"
    assert all(ours[k] == theirs[k] for k in ours), {k: (ours[k], theirs[k]) for k in ours
                                                     if ours[k] != theirs[k]}


def test_byte_tokenizer_guard_raises(inputs, tmp_path, monkeypatch):
    from clipcap_tpu_torch.utils import tokenizer

    monkeypatch.setattr(tokenizer, "get_tokenizer", lambda *a, **k: tokenizer.ByteTokenizer())
    argv = [a for a in _argv(inputs, tmp_path) if a != "--allow-fallback-tokenizer"]
    with pytest.raises(RuntimeError, match="byte-level"):
        base.prepare_model(base.build_parser().parse_args(argv + ["--device", "cpu"]))


def test_spice_model_digest_matches_jax():
    """Equal digests mean the shipped parser models load as they are
    (a mismatch would retrain and rewrite the tracked cache file)."""
    assert spice_parser._treebank_digest() == jspice_parser._treebank_digest()
    assert os.path.exists(spice_parser._cache_paths()[0])


def test_a_native_library_that_does_not_run_here_is_removed(tmp_path, monkeypatch):
    """A toolchain whose library does not run in this interpreter (here an
    environment ``CXX`` that writes no loadable library; on a GPU host, a
    wrapper that left libstdc++ out gave one that crashed, and ran away in
    host memory inside the eval process): ``build`` removes what it wrote,
    ``load`` raises, and the scorers take their Python implementations."""
    from clipcap_tpu_torch import native
    from clipcap_tpu_torch.eval import tokenization

    fake = tmp_path / "fake-cxx"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo not-a-library > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "build" / "libclipcap_native.so"))
    monkeypatch.setattr(native, "_lib", None)
    assert native.build() is False
    assert not os.path.exists(native._LIB_PATH)
    with pytest.raises(OSError):
        native.load()
    assert type(tokenization.get_tokenizer()) is tokenization.PTBTokenizer
    monkeypatch.delenv("CXX")
    assert native.build() is True and os.path.exists(native._LIB_PATH)


def test_spice_retrain_leaves_the_package_data_dir_untouched(tmp_path, monkeypatch):
    """A stale packaged cache forces a retrain: the models go to the port's
    own user cache, and the package's data directory (here a writable copy,
    patched in) and the JAX package's cache path are never written."""
    import gzip

    from clipcap_tpu_torch.eval.depparse import ArcStandardParser
    from clipcap_tpu_torch.eval.postag import PerceptronTagger

    data = tmp_path / "package_data"
    data.mkdir()
    with gzip.open(data / "spice_model_cache.json.gz", "wt") as fh:
        json.dump({"digest": "stale"}, fh)
    before = {f.name: f.read_bytes() for f in data.iterdir()}
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("CLIPCAP_SPICE_MODEL_CACHE", raising=False)
    monkeypatch.setattr(spice_parser, "_DATA_DIR", str(data))
    monkeypatch.setattr(spice_parser, "_models", None)
    monkeypatch.setattr(spice_parser, "_train", lambda: (PerceptronTagger(), ArcStandardParser()))
    spice_parser.get_models()
    assert {f.name: f.read_bytes() for f in data.iterdir()} == before
    written = home / ".cache" / "clipcap_tpu_torch" / "spice_model_cache.json.gz"
    with gzip.open(written, "rt") as fh:
        assert json.load(fh)["digest"] == spice_parser._treebank_digest()
    assert not (home / ".cache" / "clipcap_tpu").exists()
    # The next process reads the user cache: no second retrain.
    monkeypatch.setattr(spice_parser, "_models", None)
    monkeypatch.setattr(spice_parser, "_train", lambda: pytest.fail("retrained twice"))
    spice_parser.get_models()


def test_meteor_names_its_synonym_tier(caplog):
    from clipcap_tpu_torch.eval.meteor import get_meteor

    with caplog.at_level("INFO", logger="clipcap_tpu_torch.eval.meteor"):
        get_meteor(synonyms={})
    lines = [r.getMessage() for r in caplog.records if "synonym stage" in r.getMessage()]
    assert lines == ["METEOR synonym stage: the caller's synonym table"]
