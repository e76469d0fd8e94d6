"""COCOEvalCap-equivalent driver: tokenize → run all scorers → combine.

Interface parity with ClipCap's clipcap/eval/pycocoevalcap/eval.py:
``evaluate()`` fills ``.eval`` (corpus metrics incl. SPIDEr = (CIDEr +
SPICE)/2, eval.py:75-86) and ``.audioToEval`` (per-sample score maps,
eval.py:93-101).  All scorers are this framework's native implementations —
no Java subprocesses.
"""
from __future__ import annotations

from typing import Dict, List

from clipcap_tpu_torch.eval.bleu import Bleu
from clipcap_tpu_torch.eval.cider import Cider
from clipcap_tpu_torch.eval.meteor import get_meteor
from clipcap_tpu_torch.eval.rouge import Rouge
from clipcap_tpu_torch.eval.spice import Spice
from clipcap_tpu_torch.eval.tokenization import get_tokenizer


class COCOEvalCap:
    def __init__(self, coco, cocoRes):
        self.evalAudios: List[dict] = []
        self.eval: Dict[str, float] = {}
        self.audioToEval: Dict[object, dict] = {}
        self.coco = coco
        self.cocoRes = cocoRes
        self.params = {"audio_id": coco.getAudioIds()}

    def evaluate(self) -> None:
        audio_ids = self.params["audio_id"]
        gts = {aid: self.coco.audioToAnns[aid] for aid in audio_ids}
        res = {aid: self.cocoRes.audioToAnns[aid] for aid in audio_ids}

        tokenizer = get_tokenizer()
        gts = tokenizer.tokenize(gts)
        res = tokenizer.tokenize(res)

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
                    self.setEval(sc, m)
                    self.setAudioToEvalAudios(scs, gts.keys(), m)
            else:
                self.setEval(score, method)
                self.setAudioToEvalAudios(scores, gts.keys(), method)

        # SPIDEr = (CIDEr + SPICE)/2 (reference eval.py:75-86).
        spider = 0.5 * (self.eval["CIDEr"] + self.eval["SPICE"])
        self.setEval(spider, "SPIDEr")
        per_spider = {
            aid: 0.5 * (self.audioToEval[aid]["CIDEr"]
                        + self.audioToEval[aid]["SPICE"]["All"]["f"])
            for aid in self.audioToEval
        }
        for aid, value in per_spider.items():
            self.audioToEval[aid]["SPIDEr"] = value

        self.setEvalAudios()

    def setEval(self, score: float, method: str) -> None:
        self.eval[method] = float(score) if not isinstance(score, dict) else score

    def setAudioToEvalAudios(self, scores, audio_ids, method: str) -> None:
        for aid, score in zip(audio_ids, scores):
            self.audioToEval.setdefault(aid, {"audio_id": aid})
            self.audioToEval[aid][method] = score

    def setEvalAudios(self) -> None:
        self.evalAudios = list(self.audioToEval.values())
