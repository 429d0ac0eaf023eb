"""Recorded planner-session transcripts: parse, replay, export
(counterpart of ``vla_touch_tpu/planning/transcripts.py``).

A transcript file holds one JSON object per trial,

    {"trial_number": int, "start_time": str, "image": str,
     "initial_prompt": str,
     "steps": [{"assistant": str, "user_feedback"?: str}, ...]}

followed by free-form notes (pass/fail tallies).  :func:`replay_trial` drives a live
:class:`PlannerSession` with a trial's recorded assistant turns and
feedback, and :func:`trial_row` exports a live session in the same schema,
so new runs compare directly with recorded ones
(``tests/fixtures/octopi_results/`` holds fifteen such files).
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Optional

from vla_touch_tpu_torch.planning.planner import PlannerConfig, PlannerSession


def parse_results_jsonl(path: str, return_notes: bool = False):
    """Load a recorded ``results/*.jsonl`` transcript -> list of trials.

    The recorded files end with free-form notes (bare JSON strings
    / numbers, occasionally unquoted text — e.g. ``"9/10 for empty"`` in
    ``cup_force_ref_results.jsonl``); those are collected separately, since
    the manual pass/fail tallies are data, not trials.
    """
    trials, notes = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                t = json.loads(line)
            except json.JSONDecodeError:
                notes.append(line)
                continue
            if isinstance(t, dict) and "steps" in t:
                trials.append(t)
            else:
                notes.append(t)
    if not trials:
        raise ValueError(f"no planner trials in: {path}")
    return (trials, notes) if return_notes else trials


def _experiment_for(trial: dict, fallback: str = "wipe") -> str:
    p = trial.get("initial_prompt", "").lower()
    for name, kw in (("cup", "cup"), ("mango", "mango"),
                     ("wipe", "wipe")):
        if kw in p:
            return name
    return fallback


def replay_trial(trial: dict, results_dir: str,
                 experiment: Optional[str] = None) -> dict:
    """Re-drive one recorded trial through a live :class:`PlannerSession`.

    The recorded assistant turns become the scripted VLM; the recorded
    ``user_feedback`` strings become the feedback channel.  Returns the
    replayed trial in the transcript schema — equal to the recording's
    step structure by construction, which the regression test asserts.
    """
    exp = experiment or _experiment_for(trial)
    steps = trial["steps"]
    replies = [s["assistant"] for s in steps]
    it = iter(replies)

    cfg = PlannerConfig(
        experiment=exp, use_tactile=True, results_dir=results_dir,
        max_turns=max(len(steps) + 1, 1),
        session_name=f"replay_{exp}_{trial.get('trial_number', 0)}")
    session = PlannerSession(cfg, vlm_fn=lambda messages: next(it))
    # Reference sessions open with the task-specific initial prompt.
    session.messages[-1] = {"role": "user",
                            "content": trial["initial_prompt"]}

    # Drive the loop directly from the recording (session.run's DONE
    # heuristic must not cut a replay short when a recorded reply happens to
    # contain the word "done").
    session.next_action()
    for i, s in enumerate(steps):
        fb = s.get("user_feedback")
        last = i == len(steps) - 1
        if fb is None:
            if not last:
                # recording shows the planner continuing with no user turn
                session.next_action()
        elif last:
            # recording ended on a feedback turn with no further reply
            session.messages.append({"role": "user", "content": fb})
        else:
            session.send_message(fb)
    return trial_row(session, trial_number=trial.get("trial_number", 0),
                     image=trial.get("image", ""),
                     start_time=trial.get("start_time"))


def trial_row(session: PlannerSession, trial_number: int = 1,
              image: str = "", start_time: Optional[str] = None) -> dict:
    """Export a live session in the transcript schema."""
    steps = []
    msgs = [m for m in session.messages if m["role"] != "system"]
    # messages: initial prompt, then assistant turns each optionally
    # followed by a user-feedback turn (turns may repeat on either side).
    i = 1
    while i < len(msgs):
        if msgs[i]["role"] != "assistant":
            i += 1
            continue
        step = {"assistant": msgs[i]["content"]}
        if i + 1 < len(msgs) and msgs[i + 1]["role"] == "user":
            step["user_feedback"] = msgs[i + 1]["content"]
            i += 2
        else:
            i += 1
        steps.append(step)
    return {
        "trial_number": trial_number,
        "start_time": start_time or str(datetime.datetime.now()),
        "image": image,
        "initial_prompt": msgs[0]["content"] if msgs else "",
        "steps": steps,
    }


def write_results_jsonl(trials: list, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for t in trials:
            f.write(json.dumps(t) + "\n")
    return path
