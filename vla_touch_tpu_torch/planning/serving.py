"""Tactile-description serving (counterpart of
``vla_touch_tpu/planning/serving.py``): describe / rank / guess / ask over
the tactile encoder and an optional LLM, with chat-history persistence.
The HTTP layer (:func:`build_app`) needs fastapi; the service object is
driven directly otherwise."""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from vla_touch_tpu_torch.planning import encoder as PE
from vla_touch_tpu_torch.planning.datasets import clip_preprocess
from vla_touch_tpu_torch.planning.frames import extract_salient_frames
from vla_touch_tpu_torch.planning.qa import describe
from vla_touch_tpu_torch.planning.run_llm import parse_answer_option


class TactileDescriptionService:
    """describe / rank / guess / ask over tactile videos.  ``llm_fn(prompt:
    str) -> str`` is the planner LLM (for example ``make_llm_interface``'s
    ``generate_fn`` over its ``embed_text``)."""

    def __init__(self, state: PE.TactileEncoderState, llm_fn: Optional[Callable] = None,
                 history_path: Optional[str] = None, frame_size: int = 224,
                 sensor: str = "dotted"):
        self.state = state
        self.llm_fn = llm_fn
        self.history_path = history_path
        self.frame_size = frame_size
        self.sensor = sensor

    def _record(self, kind: str, payload: dict):
        if not self.history_path:
            return
        os.makedirs(os.path.dirname(self.history_path) or ".", exist_ok=True)
        with open(self.history_path, "a") as f:
            f.write(json.dumps({"kind": kind, "ts": time.time(), **payload}) + "\n")

    def _encode(self, frames: np.ndarray):
        """The salient frames' adapted feature (1, D) on the encoder's device."""
        idx = extract_salient_frames(frames.mean(-1) if frames.ndim == 4 else frames)
        sal = frames[np.clip(idx, 0, len(frames) - 1)]
        pre = clip_preprocess(sal.astype(np.uint8), self.frame_size)
        return PE.encode_tactile_video(self.state, pre[None], self.sensor)

    def _properties(self, frames) -> np.ndarray:
        return PE.classify_properties(self.state, self._encode(frames))[0].cpu().numpy()

    def describe(self, frames: np.ndarray) -> dict:
        """Tactile video -> property estimates + text description."""
        props = self._properties(frames)
        if self.llm_fn is not None:
            text = self.llm_fn(f"Describe a surface with hardness {props[0]:.1f} and "
                               f"roughness {props[1]:.1f} on a 0-10 scale.")
        else:
            text = describe(float(props[0]), float(props[1]))
        out = {"hardness": float(props[0]), "roughness": float(props[1]),
               "description": text}
        self._record("describe", out)
        return out

    def rank(self, videos: list, prop: str = "hardness") -> dict:
        """Rank videos by a property (ascending)."""
        values = []
        for frames in videos:
            props = self._properties(np.asarray(frames))
            values.append(float(props[0] if prop == "hardness" else props[1]))
        order = list(np.argsort(values))
        out = {"property": prop, "values": values, "ranking": [int(i) for i in order]}
        self._record("rank", out)
        return out

    def guess(self, frames: np.ndarray, candidates: list) -> dict:
        """Which lettered candidate is the touched object?  Describe the
        touch, then ask for a case per option ending in 'Answer: <letter>'.
        Requires ``llm_fn``."""
        if self.llm_fn is None:
            raise RuntimeError("guess requires an llm_fn")
        desc = self.describe(frames)
        letters = [chr(ord("A") + i) for i in range(len(candidates))]
        options = ", ".join(f"{l}) {c}" for l, c in zip(letters, candidates))
        prompt = (
            f"The touched object feels: {desc['description']}\n"
            f"Determine which option the above object is likely to be: "
            f"{options}?\nFollow the steps below: 1. Select the surface "
            "texture descriptions that help to distinguish between the "
            "given options. 2. Give a succinct case for each option using "
            "the selected descriptions. 3. Select the best option and "
            "format your answer in the format 'Answer: <letter>) <name> "
            "is the most likely option because <reason(s)>'.")
        generation = self.llm_fn(prompt)
        option = parse_answer_option(generation)
        out = {"candidates": list(candidates), "option": option if option in letters else None,
               "generation": generation, "description": desc["description"]}
        self._record("guess", out)
        return out

    def ask(self, query: str) -> dict:
        """Free-form follow-up through the LLM."""
        if self.llm_fn is None:
            raise RuntimeError("ask requires an llm_fn")
        out = {"query": query, "answer": self.llm_fn(query)}
        self._record("ask", out)
        return out

    def reset_history(self) -> None:
        """Truncate the chat-history log."""
        if self.history_path and os.path.exists(self.history_path):
            open(self.history_path, "w").close()


def build_app(service: TactileDescriptionService):
    """A FastAPI app over the service (needs fastapi)."""
    try:
        from fastapi import FastAPI
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("fastapi is not installed; drive TactileDescriptionService "
                           "directly or install fastapi for HTTP serving") from e

    app = FastAPI(title="vla_touch_tpu_torch tactile description service")

    @app.post("/describe")
    def describe_endpoint(payload: dict):
        return service.describe(np.asarray(payload["frames"], np.uint8))

    @app.post("/rank")
    def rank_endpoint(payload: dict):
        videos = [np.asarray(v, np.uint8) for v in payload["videos"]]
        return service.rank(videos, payload.get("property", "hardness"))

    @app.post("/guess")
    def guess_endpoint(payload: dict):
        return service.guess(np.asarray(payload["frames"], np.uint8), payload["candidates"])

    @app.post("/ask")
    def ask_endpoint(payload: dict):
        return service.ask(payload["query"])

    @app.post("/reset")
    def reset_endpoint():
        service.reset_history()
        return {"ok": True}

    return app
