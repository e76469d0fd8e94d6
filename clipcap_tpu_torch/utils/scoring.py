"""Standalone scoring: PTB-tokenize, then run the five scorers and
return per-image score dicts.  Counterpart of ``clipcap_tpu/utils/scoring.py``
on the port's own scorers (``clipcap_tpu_torch.eval``), no Java."""
from __future__ import annotations

from typing import Dict, List

from clipcap_tpu_torch.eval.bleu import Bleu
from clipcap_tpu_torch.eval.cider import Cider
from clipcap_tpu_torch.eval.meteor import get_meteor
from clipcap_tpu_torch.eval.rouge import Rouge
from clipcap_tpu_torch.eval.spice import Spice
from clipcap_tpu_torch.eval.tokenization import get_tokenizer


def generate_scores(gts: Dict, res: Dict) -> List[Dict]:
    """``gts``: {id: [ref strings or {"caption": ...}]}, ``res``: {id: [pred]}.
    Returns one dict per scorer with 'method', corpus 'score' and per-image
    'scores' (the reference's output shape)."""
    tokenizer = get_tokenizer()
    gts = tokenizer.tokenize(gts)
    res = tokenizer.tokenize(res)

    output = []
    scorers = [
        (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (get_meteor(), "METEOR"),
        (Rouge(), "ROUGE_L"),
        (Cider(), "CIDEr"),
        (Spice(), "SPICE"),
    ]
    for scorer, method in scorers:
        score, scores = scorer.compute_score(gts, res)
        if isinstance(method, list):
            for sc, scs, m in zip(score, scores, method):
                output.append({"method": m, "score": sc, "scores": scs})
        else:
            output.append({"method": method, "score": score, "scores": scores})
    return output
