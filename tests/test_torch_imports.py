"""The port keeps its own copies of the JAX-free modules it needs and
imports nothing of ``clipcap_tpu``; the copies stay interchangeable with
the originals (token ids, YAML configs, datasets on disk)."""
import ast
import os
import subprocess
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import pytest

from clipcap_tpu import config as jconfig
from clipcap_tpu.models.args import add_model_args as jadd_model_args
from clipcap_tpu.train.reader import EmbeddingReader as JEmbeddingReader
from clipcap_tpu.utils import clip_tokenizer as jclip_tokenizer
from clipcap_tpu.utils.tokenizer import get_tokenizer as jget_tokenizer
from clipcap_tpu_torch import config as tconfig
from clipcap_tpu_torch.models.args import add_model_args
from clipcap_tpu_torch.preprocess.writer import PartitionWriter, write_encoder_config
from clipcap_tpu_torch.train.reader import EmbeddingReader
from clipcap_tpu_torch.utils import clip_tokenizer
from clipcap_tpu_torch.utils.tokenizer import get_tokenizer

REPO = Path(__file__).resolve().parents[1]
TEXTS = ["A man riding a horse on the beach.", "two dogs", "", "naïve café — 東京 😀",
         "  spaces\tand\nnewlines  "]

WALK = """
import importlib, pkgutil, sys
import clipcap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(clipcap_tpu_torch.__path__, "clipcap_tpu_torch.")
         if m.name.rsplit(".", 1)[-1] != "__main__"]
assert {"clipcap_tpu_torch.eval.base", "clipcap_tpu_torch.eval.spice_parser",
        "clipcap_tpu_torch.native.meteor", "clipcap_tpu_torch.native.ptb_tokenizer",
        "clipcap_tpu_torch.finetune", "clipcap_tpu_torch.init", "clipcap_tpu_torch.init.base",
        "clipcap_tpu_torch.ops.quant", "clipcap_tpu_torch.utils.export_checkpoint",
        "clipcap_tpu_torch.utils.merge_preprocessed_datasets",
        "clipcap_tpu_torch.utils.scoring", "clipcap_tpu_torch.utils.profiling",
        "clipcap_tpu_torch.models.kimi_linear", "clipcap_tpu_torch.ops.kda",
        "clipcap_tpu_torch.models.granite_hybrid", "clipcap_tpu_torch.ops.mamba",
        "clipcap_tpu_torch.ops.gqa", "clipcap_tpu_torch.models.longcat_flash"} <= set(names)
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "clipcap_tpu"))
assert not bad, bad
print("MODULES", len(names))
"""


def test_every_port_module_imports_without_the_jax_package():
    """A fresh interpreter imports every module of the port (``__main__``
    modules aside; the eval stage and its native scorers among them):
    neither JAX nor anything of ``clipcap_tpu`` loads."""
    env = dict(os.environ, PYTHONPATH=str(REPO), HF_HUB_OFFLINE="1", OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", WALK], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split("MODULES")[1]) > 30


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("tree", ["clipcap_tpu_torch", "chip_smoke.py"])
def test_no_source_of_the_port_names_clipcap_tpu_in_an_import(tree):
    """Lazy imports inside functions too, and no module is loaded by path."""
    root = REPO / tree
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    for path in files:
        bad = [m for m in _imports(path) if m.split(".")[0] in ("clipcap_tpu", "jax")]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"
        assert "spec_from_file_location" not in path.read_text(), path


@pytest.mark.parametrize("module,families", [
    ("decoding", ("gpt2", "deepseek_v2", "kimi_linear", "granite_hybrid", "longcat_flash")),
    ("deepseek_v2", ("gpt2", "kimi_linear", "granite_hybrid", "longcat_flash")),
    ("kimi_linear", ("gpt2", "granite_hybrid", "longcat_flash")),
    ("granite_hybrid", ("gpt2", "longcat_flash")),
    ("longcat_flash", ("gpt2", "kimi_linear", "granite_hybrid")),
])
def test_decoder_families_meet_only_in_the_shared_decoding_module(module, families):
    """``models/decoding.py`` holds what every decoder family shares (the
    beam layout, the hybrid cache) and imports no family; DeepSeek-V2
    imports nothing of the others; Kimi-Linear, which shares DeepSeek-V2's
    latent attention and expert layer, nothing of GPT-2, Granite-4.0-H or
    LongCat-Flash; Granite-4.0-H, which shares the expert layer, nothing of
    GPT-2 or LongCat-Flash; LongCat-Flash, which shares the latent
    attention, the expert layer and the decode segments, nothing of the
    others."""
    path = REPO / "clipcap_tpu_torch" / "models" / f"{module}.py"
    banned = {f"clipcap_tpu_torch.models.{f}" for f in families}
    bad = [m for m in _imports(path) if m in banned]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_tokenizer_copies_give_the_same_ids():
    ours, theirs = get_tokenizer("gpt2"), jget_tokenizer("gpt2")
    assert type(ours).__name__ == type(theirs).__name__
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
    assert (ours.eos_token_id, ours.bos_token) == (theirs.eos_token_id, theirs.bos_token)
    np.testing.assert_array_equal(clip_tokenizer.tokenize(TEXTS),
                                  jclip_tokenizer.tokenize(TEXTS))


@pytest.mark.parametrize("writer,reader", [(tconfig, jconfig), (jconfig, tconfig)])
def test_yaml_config_written_by_one_package_loads_in_the_other(tmp_path, writer, reader):
    config = writer.Config(language_model="gpt2-xl", prefix_length=7, transformer_layers=3,
                           encoder_config=writer.EncoderConfig(encoder_embedding_size=768,
                                                               use_windowed_embeddings=True),
                           training_config=writer.TrainingConfig(optimizer_lr=1e-4))
    writer.save_yaml_config(config, str(tmp_path / "config.yaml"))
    loaded = reader.load_yaml_config(str(tmp_path / "config.yaml"))
    assert type(loaded).__module__ == reader.__name__
    assert loaded.to_dict() == config.to_dict()


def test_model_args_parse_as_the_jax_package_does():
    argv = ["--language-model", "gpt2-medium", "--prefix-length", "5",
            "--train-language-model", "yes"]
    ours = add_model_args(ArgumentParser()).parse_args(argv)
    theirs = jadd_model_args(ArgumentParser()).parse_args(argv)
    assert vars(ours) == vars(theirs)


def test_dataset_written_by_the_port_reads_the_same_in_both_readers(tmp_path):
    """The port's preprocess writer lays out two partitions; the port's
    reader and the JAX package's yield the same batches across them."""
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((23, 16)).astype(np.float32)
    texts = [f"caption {i}." for i in range(23)]
    write_encoder_config(tconfig.EncoderConfig(encoder_embedding_size=16), str(tmp_path))
    for i, (lo, hi) in enumerate(((0, 9), (9, 23))):
        writer = PartitionWriter(i, str(tmp_path), 2)
        writer({"embeddings": embeds[lo:hi], "text": texts[lo:hi]})
        writer.flush()
    args = (str(tmp_path / "embeddings"), str(tmp_path / "captions"))
    ours, theirs = EmbeddingReader(*args), JEmbeddingReader(*args)
    assert (ours.count, ours.dimension) == (theirs.count, theirs.dimension) == (23, 16)
    got = list(ours(batch_size=5, start=2, max_piece_size=4))
    want = list(theirs(batch_size=5, start=2, max_piece_size=4))
    assert [len(e) for e, _ in got] == [5, 5, 5, 5, 1]
    for (ge, gm), (we, wm) in zip(got, want, strict=True):
        np.testing.assert_array_equal(ge, we)
        assert gm == wm
    np.testing.assert_array_equal(np.concatenate([e for e, _ in got]), embeds[2:])
