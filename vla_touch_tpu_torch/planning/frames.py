"""Salient-frame extraction from tactile videos (the port's numpy copy of
``vla_touch_tpu/planning/frames.py``): frame differencing -> frames above a
change threshold -> longest contiguous spans -> top-k salient frames.  Used
to pick the contact window out of a GelSight recording before encoding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def frame_differences(frames: np.ndarray) -> np.ndarray:
    """(T, H, W[, C]) -> (T-1,) mean absolute inter-frame difference."""
    f = np.asarray(frames, np.float32)
    return np.abs(np.diff(f, axis=0)).mean(axis=tuple(range(1, f.ndim)))


def find_longest_spans(active: np.ndarray):
    """Longest and second-longest runs of True.  Returns (span, second_span)
    as index arrays (empty when absent)."""
    spans = []
    start = None
    for i, a in enumerate(list(active) + [False]):
        if a and start is None:
            start = i
        elif not a and start is not None:
            spans.append(np.arange(start, i))
            start = None
    spans.sort(key=len, reverse=True)
    first = spans[0] if spans else np.array([], int)
    second = spans[1] if len(spans) > 1 else np.array([], int)
    return first, second


def extract_salient_frames(frames: np.ndarray, threshold: float = 2.0,
                           min_len: int = 2, max_len: Optional[int] = None,
                           top_k: int = 5) -> np.ndarray:
    """Indices of the top-k salient frames.

    Frames whose difference from the previous frame exceeds ``threshold``
    are active; the longest active span (clipped to ``max_len``) supplies the
    salient window, within which the top-k largest-difference frames are
    returned in temporal order.  Falls back to the single
    largest-difference frame when no span qualifies (reference fallback).
    """
    diffs = frame_differences(frames)
    active = diffs > threshold
    span, _ = find_longest_spans(active)
    if len(span) < min_len:
        return np.array([int(np.argmax(diffs)) + 1])
    if max_len is not None and len(span) > max_len:
        span = span[:max_len]
    # diffs[i] measures change into frame i+1.
    frame_idx = span + 1
    order = np.argsort(-diffs[span])[:top_k]
    return np.sort(frame_idx[order])
