"""One-time asset bootstrap — ``python -m clipcap_tpu_torch.init``.

Counterpart of ``clipcap_tpu/init/base.py``: fetches the *optional*
external assets that upgrade offline fallbacks to exact behaviour, each to
where the port reads it:

* OpenAI CLIP checkpoints and the CLIP BPE merges file → ``~/.cache/clip/``
  (OpenAI ``clip``'s own cache; ``models/clip_vit.load_clip`` and
  ``utils/clip_tokenizer`` read it);
* GPT-2 tokenizer files → ``~/.cache/clipcap_tpu_torch/gpt2/`` (point
  ``$CLIPCAP_TOKENIZER_PATH`` at it);
* RoBERTa tokenizer files → ``~/.cache/clipcap_tpu_torch/roberta/`` (point
  ``$CLIPCAP_ROBERTA_TOKENIZER`` at it: ``utils/roberta_tokenizer`` reads
  them for the CLAP text tower's rerank);
* the METEOR paraphrase table and ``meteor-1.5.jar``, whose function-word
  list and WordNet synonym tables are extracted → the METEOR scorer's
  cache (``eval.meteor.CACHE_DIR``).

Every download is best effort through ``urllib.request``: offline, each
item reports and is skipped, and the port keeps working with its
documented fallbacks.
"""
from __future__ import annotations

import os
import sys
import urllib.request

from clipcap_tpu_torch.eval.meteor import CACHE_DIR as _METEOR_DIR

_CLIP_BASE = "https://openaipublic.azureedge.net/clip/models"
_CACHE = "~/.cache/clipcap_tpu_torch"
ASSETS = {
    "clip-vit-b-32": (
        f"{_CLIP_BASE}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
        "~/.cache/clip/ViT-B-32.pt",
    ),
    "clip-vit-l-14": (
        f"{_CLIP_BASE}/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
        "~/.cache/clip/ViT-L-14.pt",
    ),
    "clip-bpe": (
        "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz",
        "~/.cache/clip/bpe_simple_vocab_16e6.txt.gz",
    ),
    "gpt2-vocab": (
        "https://huggingface.co/gpt2/resolve/main/vocab.json",
        f"{_CACHE}/gpt2/vocab.json",
    ),
    "gpt2-merges": (
        "https://huggingface.co/gpt2/resolve/main/merges.txt",
        f"{_CACHE}/gpt2/merges.txt",
    ),
    "roberta-vocab": (
        "https://huggingface.co/roberta-base/resolve/main/vocab.json",
        f"{_CACHE}/roberta/vocab.json",
    ),
    "roberta-merges": (
        "https://huggingface.co/roberta-base/resolve/main/merges.txt",
        f"{_CACHE}/roberta/merges.txt",
    ),
    # The file the reference jar loads via `-a data/paraphrase-en.gz`.
    "meteor-paraphrase-en": (
        "https://github.com/tylin/coco-caption/raw/master/pycocoevalcap/meteor/data/paraphrase-en.gz",
        f"{_METEOR_DIR}/paraphrase-en.gz",
    ),
    # The jar itself (a zip archive), for the resources extracted below.
    "meteor-jar": (
        "https://github.com/tylin/coco-caption/raw/master/pycocoevalcap/meteor/meteor-1.5.jar",
        f"{_METEOR_DIR}/meteor-1.5.jar",
    ),
}


def _extract_meteor_resources(jar_path: str) -> bool:
    """Pull METEOR's scoring resources out of meteor-1.5.jar (a zip):
    ``function/en.words`` → en.words, ``synonym/english*`` → english.* —
    the data the jar scores with."""
    import zipfile

    jar_path = os.path.expanduser(jar_path)
    out_dir = os.path.expanduser(_METEOR_DIR)
    if not os.path.exists(jar_path):
        return False
    extracted = []
    try:
        with zipfile.ZipFile(jar_path) as z:
            for name in z.namelist():
                base = os.path.basename(name)
                if not base:
                    continue
                if (name.endswith("function/en.words")
                        or "/en.words" in name or name == "en.words"):
                    dest = os.path.join(out_dir, "en.words")
                elif "synonym" in name and "english" in base:
                    dest = os.path.join(out_dir, base)
                else:
                    continue
                with z.open(name) as src, open(dest + ".tmp", "wb") as dst:
                    dst.write(src.read())
                os.replace(dest + ".tmp", dest)
                extracted.append(os.path.basename(dest))
    except Exception as e:
        print(f"  meteor resource extraction failed: {e}")
        return False
    if extracted:
        print(f"  extracted from jar: {', '.join(sorted(extracted))}")
    else:
        print("  no function/synonym resources found inside the jar")
    return bool(extracted)


def _fetch(url: str, dest: str) -> bool:
    dest = os.path.expanduser(dest)
    if os.path.exists(dest):
        print(f"  already present: {dest}")
        return True
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    try:
        print(f"  fetching {url}")
        urllib.request.urlretrieve(url, dest)  # nosec - explicit user action
        return True
    except Exception as e:
        print(f"  skipped ({e})")
        return False


def init() -> int:
    print("clipcap_tpu_torch.init: fetching optional assets (best-effort)")
    got_any = False
    for name, (url, dest) in ASSETS.items():
        print(f"[{name}]")
        got = _fetch(url, dest)
        got_any |= got
        if got and name == "meteor-jar":
            _extract_meteor_resources(dest)
    if not got_any:
        print(
            "No assets could be fetched (offline?). The port still runs "
            "with random-weight encoders and fallback tokenizers; place the "
            "files listed above manually for exact pretrained behavior.")
    else:
        print(f"GPT-2 tokenizer: set CLIPCAP_TOKENIZER_PATH={os.path.expanduser(_CACHE)}/gpt2")
    return 0


if __name__ == "__main__":
    sys.exit(init())
