"""The tactile-informed task planner's session loop (counterpart of
``vla_touch_tpu/planning/planner.py``): a VLM proposes ONE primitive action
per turn and receives tactile feedback between turns.  The VLM is any
callable ``vlm_fn(messages) -> str`` (a local Qwen2-VL composed from
``planning/qwen2vl.py`` and ``planning/llm.py``, or :func:`openai_vlm`);
the planner's logic, its feedback channels and the session's jsonl log are
this module's.

Feedback channels: a tactile description (the local encoder and LLM), a
force vector (a GelSight force file or the marker tracker of
``ops/marker_tracking.py``), and manual hardness / roughness values.  A
session appends one JSON row per message to ``<results_dir>/<name>.jsonl``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np

SYSTEM_PROMPT = (
    "You are a robot task planner with access to tactile feedback. "
    "At each turn, propose EXACTLY ONE primitive action for the robot to "
    "execute next, phrased as a short imperative instruction. After each "
    "action you will receive feedback (tactile readings, force measurements, "
    "or operator observations). Use the feedback to decide the next action. "
    "When the task is complete, reply with DONE."
)

# The three experiments of the Octopi planner (its touch_vla.py).
EXPERIMENTS = {
    "wipe": {
        "task_prompt": "Wipe the liquid off the table with the sponge. "
                       "Press hard enough to absorb liquid but do not crush "
                       "the sponge.",
        "primitives": ["grasp sponge", "press sponge", "wipe left",
                       "wipe right", "lift sponge", "release sponge"],
    },
    "mango": {
        "task_prompt": "Select the ripest mango by gently squeezing each "
                       "candidate, then place the ripest one in the basket.",
        "primitives": ["squeeze mango", "pick up the mango",
                       "place mango in basket"],
    },
    "cup": {
        "task_prompt": "Insert the cup into the holder without crushing it; "
                       "adjust your grip force based on the cup's stiffness.",
        "primitives": ["grasp cup", "tighten grip", "loosen grip",
                       "insert cup", "release cup"],
    },
}


@dataclasses.dataclass
class PlannerConfig:
    experiment: str = "wipe"
    max_turns: int = 20
    use_tactile: bool = True          # False = no_touch baseline
    results_dir: str = "results"
    session_name: Optional[str] = None


class TactileFeedback:
    """Feedback assembly from the available channels."""

    def __init__(self, describe_fn: Optional[Callable] = None):
        """``describe_fn(frames) -> str``: the local tactile-LLM description
        path (Octopi); optional."""
        self.describe_fn = describe_fn

    def from_force(self, force: np.ndarray) -> str:
        f = np.asarray(force, np.float64).reshape(-1)
        mag = float(np.linalg.norm(f[:2])) if f.size >= 2 else float(abs(f[0]))
        return (f"Force measurement: direction=({f[0]:+.3f}, {f[1]:+.3f}), "
                f"magnitude={mag:.3f}.")

    def from_properties(self, hardness: float, roughness: float) -> str:
        return (f"Tactile properties: hardness={hardness:.2f}, "
                f"roughness={roughness:.2f} (scale 0-10).")

    def from_frames(self, frames) -> str:
        if self.describe_fn is None:
            return "Tactile video recorded (no description model attached)."
        return self.describe_fn(frames)


class PlannerSession:
    """One interactive planning session (``run_interactive_session``)."""

    def __init__(self, cfg: PlannerConfig, vlm_fn: Callable,
                 feedback: Optional[TactileFeedback] = None):
        self.cfg = cfg
        self.vlm_fn = vlm_fn
        self.feedback = feedback or TactileFeedback()
        exp = EXPERIMENTS[cfg.experiment]
        self.messages = [
            {"role": "system", "content": SYSTEM_PROMPT},
            {"role": "user", "content": exp["task_prompt"]},
        ]
        self.log: list = []
        os.makedirs(cfg.results_dir, exist_ok=True)
        name = cfg.session_name or f"{cfg.experiment}_{int(time.time())}"
        self.log_path = os.path.join(cfg.results_dir, f"{name}.jsonl")

    def _record(self, role: str, content: str):
        row = {"role": role, "content": content, "ts": time.time()}
        self.log.append(row)
        with open(self.log_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def send_message(self, content: str) -> str:
        """User/feedback turn -> assistant action (``send_message``)."""
        self.messages.append({"role": "user", "content": content})
        self._record("user", content)
        reply = self.vlm_fn(self.messages)
        self.messages.append({"role": "assistant", "content": reply})
        self._record("assistant", reply)
        return reply

    def next_action(self) -> str:
        reply = self.vlm_fn(self.messages)
        self.messages.append({"role": "assistant", "content": reply})
        self._record("assistant", reply)
        return reply

    def run(self, feedback_fn: Callable[[str, int], Optional[str]]) -> dict:
        """Drive the loop: the planner proposes actions; ``feedback_fn(action,
        turn)`` executes it (robot or operator) and returns feedback text, or
        None to finish.  Returns the session summary."""
        action = self.next_action()
        for turn in range(self.cfg.max_turns):
            if "DONE" in action.upper():
                break
            fb = feedback_fn(action, turn)
            if fb is None:
                break
            if not self.cfg.use_tactile:
                fb = "Action executed."  # no-touch baseline strips feedback
            action = self.send_message(fb)
        return {"turns": len([m for m in self.messages
                              if m["role"] == "assistant"]),
                "log_path": self.log_path,
                "completed": "DONE" in action.upper()}


def run_interactive_session(experiment: str, vlm_fn: Callable,
                            feedback_fn: Callable, use_tactile: bool = True,
                            results_dir: str = "results",
                            max_turns: int = 20) -> dict:
    """One session from its settings, under the Octopi planner's name."""
    cfg = PlannerConfig(experiment=experiment, use_tactile=use_tactile,
                        results_dir=results_dir, max_turns=max_turns)
    session = PlannerSession(cfg, vlm_fn)
    return session.run(feedback_fn)


def openai_vlm(model: str = "gpt-4o", api_key: Optional[str] = None):
    """Adapter producing a ``vlm_fn`` backed by the OpenAI API (the
    Octopi planner's backend).  Gated: the openai package and network are
    optional; environments without them use any other callable."""
    try:
        from openai import OpenAI
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "openai package not installed; pass a custom vlm_fn") from e
    client = OpenAI(api_key=api_key)

    def vlm_fn(messages):
        out = client.chat.completions.create(model=model, messages=messages)
        return out.choices[0].message.content

    return vlm_fn
