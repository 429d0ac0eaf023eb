"""Evaluation of the planner and its tactile encoder (counterpart of
``vla_touch_tpu/planning/eval.py``): property rankings (Kendall tau and
exact-match accuracy), scenario reasoning, and the encoder's threshold
classification accuracy and pairwise comparison success."""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
from scipy.stats import kendalltau


def parse_ranking(text: str, items: Sequence[str]) -> Optional[list]:
    """The ranking of ``items`` in generated text: their order of first
    mention (case-insensitive); None when one is not mentioned."""
    positions = {}
    low = text.lower()
    for it in items:
        m = re.search(re.escape(it.lower()), low)
        if m is None:
            return None
        positions[it] = m.start()
    return sorted(items, key=lambda it: positions[it])


def evaluate_ranking(predicted: Sequence[Sequence[str]],
                     ground_truth: Sequence[Sequence[str]]) -> dict:
    """Mean Kendall tau over the predictions that rank the right items, and
    exact-match accuracy over all of them (a missing or wrong-item
    prediction counts as a miss)."""
    taus, exact = [], []
    for pred, gt in zip(predicted, ground_truth):
        if pred is None or set(pred) != set(gt):
            exact.append(0.0)
            continue
        rank_gt = {item: i for i, item in enumerate(gt)}
        tau, _ = kendalltau([rank_gt[item] for item in pred], list(range(len(gt))))
        taus.append(tau)
        exact.append(1.0 if list(pred) == list(gt) else 0.0)
    return {"kendall_tau": float(np.mean(taus)) if taus else 0.0,
            "accuracy": float(np.mean(exact)) if exact else 0.0,
            "num_evaluated": len(exact)}


def evaluate_reasoning(predictions: Sequence[str], targets: Sequence[str]) -> dict:
    """Scenario-reasoning accuracy: a prediction is right when the object it
    names first ("object X") contains the target or is contained in it (the
    whole prediction when it names none)."""
    correct = 0
    for pred, target in zip(predictions, targets):
        m = re.search(r"object\s+([A-Za-z0-9_]+)", pred or "", re.IGNORECASE)
        named = f"object {m.group(1)}".lower() if m else (pred or "").lower()
        if target.lower() in named or named in target.lower():
            correct += 1
    return {"accuracy": correct / max(len(targets), 1), "num_evaluated": len(targets)}


def threshold_classification_accuracy(preds: np.ndarray, labels: np.ndarray,
                                      threshold: float) -> float:
    """Share of samples on the same side of ``threshold`` in prediction and
    label (e.g. soft / hard at a hardness cut)."""
    p = np.asarray(preds).reshape(-1) > threshold
    lab = np.asarray(labels).reshape(-1) > threshold
    return float(np.mean(p == lab))


def pairwise_comparison_success(preds: np.ndarray, labels: np.ndarray) -> float:
    """Share of the pairs with unequal labels whose predicted order matches
    the labels' (1.0 when there is no such pair)."""
    p = np.asarray(preds).reshape(-1)
    lab = np.asarray(labels).reshape(-1)
    correct, total = 0, 0
    for i in range(len(p)):
        for j in range(i + 1, len(p)):
            if lab[i] == lab[j]:
                continue
            total += 1
            if (p[i] > p[j]) == (lab[i] > lab[j]):
                correct += 1
    return correct / total if total else 1.0
