"""PhysiCLeAR object tables and prompt data (counterpart of
``vla_touch_tpu/planning/physiclear.py``), read from the port's copy of
``planning/data/physiclear.json`` (byte for byte the JAX package's).

Module attributes, loaded on first use:

- ``OBJECTS_WITH_PARTS``  display name -> [sample ids]
- ``TRAIN_OBJECTS`` / ``VAL_OBJECTS`` / ``TEST_OBJECTS`` split lists
- ``OBJECTS_PART_NAMES``  sample id -> display name
- ``OPEN_SET_TEXTURES``   sample id -> open-set texture adjectives
- ``HARDNESS_RANK_REGRESSION`` / ``ROUGHNESS_RANK_REGRESSION``
  sample id -> human 0..10 rating
- ``RATINGS``             {"hardness": ..., "roughness": ...}
- ``SCENARIOS``           the scenario-QA prompt templates
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "physiclear.json")

_KEYS = {
    "OBJECTS_WITH_PARTS": "objects_with_parts",
    "TRAIN_OBJECTS": "train_objects",
    "VAL_OBJECTS": "val_objects",
    "TEST_OBJECTS": "test_objects",
    "OBJECTS_PART_NAMES": "objects_part_names",
    "OPEN_SET_TEXTURES": "open_set_textures",
    "HARDNESS_RANK_REGRESSION": "hardness",
    "ROUGHNESS_RANK_REGRESSION": "roughness",
    "SCENARIOS": "scenarios",
}


@lru_cache(maxsize=1)
def _data() -> dict:
    with open(_DATA_PATH) as f:
        return json.load(f)


def __getattr__(name: str):
    if name == "RATINGS":
        return {"hardness": _data()["hardness"], "roughness": _data()["roughness"]}
    if name in _KEYS:
        return _data()[_KEYS[name]]
    raise AttributeError(name)


def get_categorical_labels(label: float, bins: int = 4) -> int:
    """A 0..10 human rating bucketed into ``bins`` classes; a rating exactly
    on a boundary belongs to the bucket below it."""
    label = max(0, min(10, label))
    interval = 10 / bins
    category = label // interval
    if category > 0 and label % interval == 0:
        category -= 1
    return int(category)


def property_order(sample_ids, index_labels, prop: str, decreasing: bool = True) -> str:
    """The ranking answer: sample ids sorted by their human rating of
    ``prop``, each shown by its question label, joined with `` > `` (``
    >= `` between equal ratings)."""
    ratings = _data()[prop]
    pairs = sorted(((i, ratings[s]) for i, s in enumerate(sample_ids)),
                   key=lambda x: x[1], reverse=decreasing)
    out = []
    for j, (idx, val) in enumerate(pairs):
        out.append(str(index_labels[idx]))
        if j != len(pairs) - 1:
            out.append(" >= " if val == pairs[j + 1][1] else " > ")
    return "".join(out)


def split_objects(split: str) -> list:
    return _data()[{"train": "train_objects", "val": "val_objects",
                    "test": "test_objects"}[split]]


def object_registry(split: str = "train", tactile_root: str = "") -> dict:
    """name -> {tactile, hardness, roughness, textures, display} over a
    split's objects, the shape :mod:`planning.qa`'s generators take."""
    d = _data()
    return {name: {"tactile": os.path.join(tactile_root, name, "tactile"),
                   "hardness": float(d["hardness"][name]),
                   "roughness": float(d["roughness"][name]),
                   "textures": d["open_set_textures"].get(name, []),
                   "display": d["objects_part_names"].get(name, name)}
            for name in split_objects(split)}
