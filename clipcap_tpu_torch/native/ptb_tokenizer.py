"""ctypes front-end for the C++ PTB tokenizer (drop-in for
clipcap_tpu_torch.eval.tokenization.PTBTokenizer)."""
from __future__ import annotations

from typing import Dict, List

from clipcap_tpu_torch.native import _take_string, load


def ptb_tokenize_line(line: str) -> List[str]:
    lib = load()
    out = _take_string(lib, lib.ccn_ptb_tokenize(line.encode("utf-8")))
    return out.split(" ") if out else []


class PTBTokenizer:
    def __init__(self):
        self._lib = load()

    def tokenize(self, captions_for_image: Dict) -> Dict:
        lib = self._lib
        out: Dict = {}
        for key, caps in captions_for_image.items():
            out[key] = []
            for cap in caps:
                text = cap["caption"] if isinstance(cap, dict) else cap
                out[key].append(_take_string(lib, lib.ccn_ptb_tokenize(text.encode("utf-8"))))
        return out
