"""COCO-format annotation container.

Fresh, minimal re-implementation of the audio-renamed pycocotools ``COCO``
class the reference vendors (ClipCap's clipcap/eval/pycocotools/
coco.py:62-115,268-285): annotation indexing by sample id plus ``loadRes``
validation — just what the caption-eval path touches (no segmentation /
bbox machinery).
"""
from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Union


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.audioToAnns: Dict[object, List[dict]] = {}
        self.audios: Dict[object, dict] = {}
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file, "r") as f:
                    self.dataset = json.load(f)
            else:
                self.dataset = annotation_file
            self.createIndex()

    def createIndex(self) -> None:
        for ann in self.dataset.get("annotations", []):
            self.audioToAnns.setdefault(ann["audio_id"], []).append(ann)
            self.anns[ann["id"]] = ann
        for sample in self.dataset.get("audio samples", []):
            self.audios[sample["id"]] = sample

    def getAudioIds(self) -> List:
        return list(self.audios.keys())

    def loadRes(self, res_input: Union[str, list]) -> "COCO":
        """Build a result COCO from a predictions list/file; validates that
        result ids are a subset of this object's sample ids
        (reference coco.py:268-285)."""
        if isinstance(res_input, str):
            with open(res_input, "r") as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(res_input)
        assert isinstance(anns, list), "results must be a list of dicts"

        res = COCO()
        anns_ids = {ann["audio_id"] for ann in anns}
        own_ids = set(self.getAudioIds())
        assert anns_ids <= own_ids, "results contain ids absent from the reference set"

        for i, ann in enumerate(anns):
            ann["id"] = i + 1
        res.dataset = {
            "audio samples": [{"id": aid} for aid in anns_ids],
            "annotations": anns,
            "type": "captions",
        }
        res.createIndex()
        return res
