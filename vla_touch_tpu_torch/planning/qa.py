"""The property words and the prompt marker of the planner's QA (the port's
copy of the parts of ``vla_touch_tpu/planning/qa.py`` that serving uses)."""

from __future__ import annotations

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
