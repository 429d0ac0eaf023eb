"""QA generation from tactile property annotations (counterpart of
``vla_touch_tpu/planning/qa.py``): the property words and the prompt marker
serving uses, description / ranking / scenario rows with ``<tact>``
placeholders from per-object ratings, the PhysiCLeAR generators of the chat
schema, and their flattening into the rows of
:class:`planning.datasets.TactileLLMDataset`.

Every draw goes through ``np.random.default_rng(seed)`` in the JAX
package's order, so both packages write the same rows.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Sequence

import numpy as np

from vla_touch_tpu_torch.planning import physiclear as PC

logger = logging.getLogger("qa")

HARDNESS_WORDS = [
    (2.0, "very soft"), (4.0, "soft"), (6.0, "moderately hard"),
    (8.0, "hard"), (10.1, "very hard"),
]
ROUGHNESS_WORDS = [
    (2.0, "very smooth"), (4.0, "smooth"), (6.0, "moderately rough"),
    (8.0, "rough"), (10.1, "very rough"),
]

# where a chat turn places a tactile video (the LLM splice's ``<tact>``)
TACT_MARKER = "<tact_tokens>"


def property_word(value: float, table) -> str:
    for cut, word in table:
        if value < cut:
            return word
    return table[-1][1]


def describe(hardness: float, roughness: float) -> str:
    return (f"This surface feels {property_word(hardness, HARDNESS_WORDS)} "
            f"and {property_word(roughness, ROUGHNESS_WORDS)}.")


def generate_description_qa(objects: dict, split: str = "train") -> list:
    """objects: {name: {"tactile": dir, "hardness": h, "roughness": r}}."""
    rows = []
    for name, o in objects.items():
        rows.append({
            "split": split,
            "question": ("Describe the tactile properties of the object in "
                         "this touch recording: <tact>"),
            "tactile": [o["tactile"]],
            "answer": describe(o["hardness"], o["roughness"]),
            "object": name,
        })
    return rows


def generate_ranking_qa(objects: dict, prop: str = "hardness",
                        group_size: int = 3, n_groups: int = 10,
                        split: str = "train", seed: int = 0) -> list:
    """Rank `group_size` objects by a property (ascending)."""
    rng = np.random.default_rng(seed)
    names = list(objects)
    rows = []
    for _ in range(n_groups):
        group = list(rng.choice(names, size=min(group_size, len(names)),
                                replace=False))
        ranked = sorted(group, key=lambda n: objects[n][prop])
        placeholders = ", ".join(f"object {chr(65 + i)}: <tact>"
                                 for i in range(len(group)))
        rows.append({
            "split": split,
            "question": (f"Rank these objects from least to most {prop}. "
                         f"{placeholders}"),
            "tactile": [objects[n]["tactile"] for n in group],
            "answer": " < ".join(
                f"object {chr(65 + group.index(n))}" for n in ranked),
            "objects": group,
            "ranking": ranked,
            "property": prop,
        })
    return rows


def generate_scenario_qa(objects: dict, scenarios: Optional[Sequence[dict]]
                         = None, split: str = "train") -> list:
    """Scenario reasoning: pick the right object for a requirement
    (generate_qa.py:172+)."""
    scenarios = scenarios or [
        {"need": "a soft object to cushion a fragile item",
         "prop": "hardness", "pick": "min"},
        {"need": "a rough object to scrub a dirty pan",
         "prop": "roughness", "pick": "max"},
        {"need": "a hard object to press a stuck button",
         "prop": "hardness", "pick": "max"},
    ]
    names = list(objects)
    rows = []
    for sc in scenarios:
        vals = [objects[n][sc["prop"]] for n in names]
        best = names[int(np.argmax(vals) if sc["pick"] == "max"
                         else np.argmin(vals))]
        placeholders = ", ".join(f"object {chr(65 + i)}: <tact>"
                                 for i in range(len(names)))
        rows.append({
            "split": split,
            "question": (f"You need {sc['need']}. Based on these touch "
                         f"recordings, which object should you use? "
                         f"{placeholders}"),
            "tactile": [objects[n]["tactile"] for n in names],
            "answer": f"object {chr(65 + names.index(best))}",
            "objects": names,
            "target": best,
        })
    return rows


def write_qa_file(rows: list, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)
    return path


# ---- the PhysiCLeAR generators (the chat schema) ---------------------------------
#
# Rows ``{"info": ..., "chat": [{"role": "user"|"assistant", "content": ...}]}``
# with ``<tact_tokens>`` markers, over the 90-object PhysiCLeAR tables.


def _sample_path(samples: dict, name: str, rng) -> str:
    """samples: object id -> list of recording dirs (reference
    ``{split}_samples.json`` shape)."""
    recs = samples[name]
    return recs[int(rng.integers(len(recs)))] + "/tactile"


def generate_physiclear_description_ranking_qa(
        samples: dict, num_samples: int, *, split: str = "train",
        use_parts: bool = False, seed: int = 0) -> list:
    """Description / ranking chat QA over the PhysiCLeAR tables.

    Each row randomly mixes describe-only / rank-only / describe+rank over
    1..5 objects (optionally 2-part objects); descriptions are shuffled
    open-set texture adjectives, rankings are decreasing hardness and
    roughness with ``>=`` ties (``generate_qa.py:8-28,31-169``).
    """
    rng = np.random.default_rng(seed)
    textures = PC.OPEN_SET_TEXTURES
    pool = [n for n in PC.split_objects(split) if n in samples]
    if not pool:
        raise ValueError(f"no {split} objects present in samples")
    rows = []
    for _ in range(num_samples):
        n_obj = int(rng.integers(1, min(5, len(pool)) + 1))
        get_order = n_obj > 1 and bool(rng.integers(2))
        get_description = True if not get_order else bool(rng.integers(2))
        if n_obj == 1:
            q = ["Describe the object in the following tactile "
                 "video(s).\n\n"]
        elif get_description and get_order:
            q = ["Describe the objects in the following tactile videos and "
                 "rank them in decreasing hardness and roughness.\n\n"]
        elif get_description:
            q = ["Describe the objects in the following tactile videos.\n\n"]
        else:
            q = ["Rank the objects in the following tactile videos in "
                 "decreasing hardness and roughness.\n\n"]

        picked = list(rng.choice(pool, size=n_obj, replace=False))
        indices = list(rng.permutation(np.arange(1, 6))[:n_obj])
        ans, tactile, parts, labels = [], [], [], []
        objects_dict = {}
        for i, (obj, idx) in enumerate(zip(picked, indices)):
            n_parts = int(rng.integers(1, 3)) if use_parts else 1
            # extra parts come from the pool minus the object; cap the group
            # at what the pool can supply (a 1-object split must not crash)
            n_parts = min(n_parts, len(pool))
            if n_parts == 1:
                tactile.append(_sample_path(samples, obj, rng))
                objects_dict[f"Object {idx}"] = obj
                parts.append(obj)
                labels.append(f"{idx}")
                q += [f"Object {idx}: ", TACT_MARKER]
                if get_description:
                    words = list(textures[obj])
                    rng.shuffle(words)
                    ans.append(f"Object {idx}: {', '.join(words)}.")
            else:
                # extra parts drawn WITHOUT the object itself (or repeats):
                # identical parts would yield degenerate `3.1 >= 3.2` ranks
                others = [o for o in pool if o != obj]
                group = [obj] + list(rng.choice(others, size=n_parts - 1,
                                                replace=False))
                objects_dict[f"Object {idx}"] = {
                    p + 1: g for p, g in enumerate(group)}
                q.append(f"Object {idx}\n")
                if get_description:
                    ans.append(f"Object {idx}\n")
                for p, g in enumerate(group):
                    tactile.append(_sample_path(samples, g, rng))
                    parts.append(g)
                    labels.append(f"{idx}.{p + 1}")
                    q += [f"Part {idx}.{p + 1}: ", TACT_MARKER]
                    if p != n_parts - 1:
                        q.append("\n")
                    if get_description:
                        words = list(textures[g])
                        rng.shuffle(words)
                        ans.append(f"Part {idx}.{p + 1}: "
                                   f"{', '.join(words)}.")
                        if p != n_parts - 1:
                            ans.append("\n")
            if i != n_obj - 1:
                q.append("\n\n")
                if get_description:
                    ans.append("\n\n")
        if get_order:
            if get_description:
                ans.append("\n\n")
            h = PC.property_order(parts, labels, "hardness")
            r = PC.property_order(parts, labels, "roughness")
            noun = "Object parts" if use_parts else "Objects"
            ans.append(f"{noun} ranked in decreasing hardness: {h}\n"
                       f"{noun} ranked in decreasing roughness: {r}")
        rows.append({
            "info": {"get_description": get_description,
                     "get_order": get_order, "decreasing": True,
                     "num_objects": n_obj, "tactile": tactile,
                     "objects": objects_dict,
                     "exploratory_procedures": ["pressing", "sliding"]},
            "chat": [{"role": "user", "content": "".join(q)},
                     {"role": "assistant", "content": "".join(ans)}],
        })
    return rows


def generate_physiclear_scenario_qa(samples: dict, num_samples: int, *,
                                    scenarios: Optional[Sequence[str]] = None,
                                    seed: int = 0) -> list:
    """Scenario-reasoning chat QA: describe one target recording, then pick
    which lettered candidate object it is (``generate_qa.py:172-366``,
    single-object branch), including the follow-up verification turn."""
    rng = np.random.default_rng(seed)
    info = PC.SCENARIOS
    use = {k: v for k, v in info.items()
           if scenarios is None or k in scenarios}
    # Validate every candidate scenario up front — a malformed entry must
    # fail deterministically, not only when the RNG happens to draw it.
    for name, sc in use.items():
        if len(sc["target_sample"]) != len(sc["all_candidate"]):
            raise ValueError(
                f"scenario {name!r}: target_sample "
                f"({len(sc['target_sample'])}) and all_candidate "
                f"({len(sc['all_candidate'])}) must be parallel lists")
    rows, seen = [], set()
    # Distinct rows are capped by the available unique recordings (the
    # reference dedups the same way); keep drawing until the request is met
    # or the pool is provably exhausted, and say so rather than silently
    # under-delivering.
    attempts, max_attempts = 0, max(50 * num_samples, 200)
    while len(rows) < num_samples and attempts < max_attempts:
        attempts += 1
        name = list(use)[int(rng.integers(len(use)))]
        sc = use[name]
        options = [f"{chr(ord('A') + i)})"
                   for i in range(len(sc["all_candidate"]))]
        ridx = int(rng.integers(len(sc["target_sample"])))
        target = sc["target_sample"][ridx]
        if target not in samples:
            continue
        tactile = [_sample_path(samples, target, rng)]
        if tuple(tactile) in seen:
            continue
        seen.add(tuple(tactile))
        words = list(PC.OPEN_SET_TEXTURES[target])
        rng.shuffle(words)
        reasoning = f"{options[ridx]} {sc['all_candidate'][ridx]}"
        q2 = sc["question"] + ", ".join(
            f"{options[i]} {c}" for i, c in
            enumerate(sc["all_candidate"][:-1]))
        q2 += f", {options[len(sc['all_candidate']) - 1]} " \
              f"{sc['all_candidate'][-1]}?" if len(sc["all_candidate"]) > 1 \
              else "?"
        chat = [
            {"role": "user", "content":
             "Describe the object in the following tactile video(s).\n\n"
             f"Object 1: {TACT_MARKER}"},
            {"role": "assistant",
             "content": f"Object 1: {', '.join(words)}."},
            {"role": "user",
             "content": sc["pre_instruction"] + q2 +
             sc["post_instruction"]},
            {"role": "assistant", "content": reasoning},
        ]
        if sc.get("follow_up"):
            chat += [{"role": "user", "content": sc["follow_up"]},
                     {"role": "assistant", "content": reasoning}]
        rows.append({
            "info": {"scenario": name, "target": target,
                     "tactile": tactile,
                     "objects": {"Object 1": target},
                     "num_candidates": len(sc["all_candidate"])},
            "chat": chat,
        })
    if len(rows) < num_samples:
        logger.warning(
            "scenario QA: %d/%d rows generated — unique target recordings "
            "exhausted", len(rows), num_samples)
    return rows


def chat_rows_to_llm_rows(rows: list) -> list:
    """Flatten reference chat-schema rows into the ``{question, tactile,
    answer}`` rows :class:`planning.datasets.TactileLLMDataset`
    consumes (first user/assistant exchange; ``<tact_tokens>`` -> ``<tact>``)."""
    out = []
    for r in rows:
        chat = r["chat"]
        out.append({
            "question": chat[0]["content"].replace(TACT_MARKER, "<tact>"),
            "answer": chat[1]["content"],
            "tactile": list(r["info"]["tactile"]),
            "info": r["info"],
        })
    return out
