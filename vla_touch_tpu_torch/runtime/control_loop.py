"""Control-loop runtime: the chunk scheduler (counterpart of
``vla_touch_tpu/runtime/control_loop.py``; numpy only).

- The policy replans a 64-step chunk every ``replan_interval`` (16)
  executed steps.  With ``plan_warm_fn`` every replan after the first is
  warm-started: the previous chunk, shifted by the ticks already executed
  and padded with its last action, is the prior of the solver's tail
  (``RoboticDiffusionTransformerModel.step(prior_actions=, skip_steps=)``).
- Refiners: ``none`` executes the chunk; ``bridge`` refines the next
  ``refine_horizon`` steps once per replan; ``lstm`` refines step by step
  with a carry kept between ticks (any ``lstm_step_fn``).
- A 2-frame observation window, gripper deadband smoothing, and runtime
  instruction switching that makes the scheduler replan at once.

The loop consumes :class:`Observation`\\ s; a robot or a recorded episode
(:class:`EpisodeReplay`) drives it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Observation:
    state: np.ndarray                     # (D_low,) raw robot state
    images: list                          # per-camera HxWx3 uint8 (or None)
    force: Optional[np.ndarray] = None    # (3,) GelSight force


@dataclasses.dataclass(frozen=True)
class ControlLoopConfig:
    chunk_size: int = 64
    replan_interval: int = 16
    refiner: str = "none"                 # none | bridge | lstm
    refine_horizon: int = 16              # bridge refinement window
    gripper_deadband: float = 2.0         # raw gripper units
    publish_rate_hz: float = 6.0


class ObservationWindow:
    """A rolling window of the last ``size`` observations; the first
    observation fills every slot."""

    def __init__(self, size: int = 2):
        self.size = size
        self.buffer: list = []

    def update(self, obs: Observation):
        if not self.buffer:
            self.buffer = [obs] * self.size
        else:
            self.buffer = self.buffer[1:] + [obs]

    @property
    def current(self) -> Observation:
        return self.buffer[-1]

    def image_sequence(self) -> list:
        """The 6-image order [ext_{t-1}, right_{t-1}, left_{t-1}, ext_t, ...];
        missing cameras are None."""
        out = []
        for obs in self.buffer:
            imgs = list(obs.images) + [None] * (3 - len(obs.images))
            out.extend(imgs[:3])
        return out


class GripperSmoother:
    """Hold the gripper command until it moves by more than ``deadband``."""

    def __init__(self, deadband: float):
        self.deadband = deadband
        self.last = None

    def __call__(self, g: float) -> float:
        if self.last is None or abs(g - self.last) > self.deadband:
            self.last = float(g)
        return self.last


class InstructionStore:
    """Precomputed instruction embeddings with runtime switching; a switch
    bumps ``version``, which makes :class:`ChunkScheduler` replan at its
    next tick.  ``instruction_dict``: ``{"all_instructions": [names...],
    name: embedding, ...}``."""

    def __init__(self, instruction_dict: dict, initial: Optional[str] = None):
        self.all_instructions = list(instruction_dict["all_instructions"])
        self._embeds = {k: instruction_dict[k] for k in self.all_instructions}
        self.current = initial or self.all_instructions[0]
        self.version = 0

    @property
    def embedding(self):
        return self._embeds[self.current]

    def switch(self, instruction_or_index) -> str:
        """Make an instruction (by name or index) current; raises KeyError
        for a name that is not in the store."""
        if isinstance(instruction_or_index, int):
            self.current = self.all_instructions[instruction_or_index]
        else:
            if instruction_or_index not in self._embeds:
                raise KeyError(f"unknown instruction {instruction_or_index!r}")
            self.current = instruction_or_index
        self.version += 1
        return self.current


def shift_prior(chunk: np.ndarray, executed: int) -> np.ndarray:
    """The previous chunk shifted by ``executed`` ticks and padded with its
    last action: the warm replan's prior, the chunk's length kept."""
    k = min(executed, chunk.shape[0])
    return np.concatenate([chunk[k:], np.repeat(chunk[-1:], k, axis=0)], axis=0)


class ChunkScheduler:
    """Replan / refine / execute scheduler.

    ``plan_fn(window) -> (chunk_size, D)`` chunk;
    ``plan_warm_fn(window, prior) -> (chunk_size, D)`` (optional) for every
    replan after the first, ``prior`` from :func:`shift_prior`;
    ``bridge_refine_fn(obs, chunk_window) -> refined window`` (optional);
    ``lstm_step_fn(carry, obs, action, first) -> (carry, refined action)``
    (optional).
    """

    def __init__(self, cfg: ControlLoopConfig, plan_fn: Callable,
                 bridge_refine_fn: Optional[Callable] = None,
                 lstm_step_fn: Optional[Callable] = None,
                 instructions: Optional[InstructionStore] = None,
                 plan_warm_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.plan_fn = plan_fn
        self.plan_warm_fn = plan_warm_fn
        self.bridge_refine_fn = bridge_refine_fn
        self.lstm_step_fn = lstm_step_fn
        self.instructions = instructions
        self._instruction_version = instructions.version if instructions else 0
        self.window = ObservationWindow(2)
        self.smoother = GripperSmoother(cfg.gripper_deadband)
        self.reset()

    def reset(self):
        self.t = 0
        self.chunk = None
        self.chunk_pos = 0
        self.lstm_carry = None
        self.window.buffer = []

    def tick(self, obs: Observation) -> np.ndarray:
        """One control tick: returns the action to execute."""
        cfg = self.cfg
        self.window.update(obs)
        # an instruction switch invalidates the current chunk: replan now
        if (self.instructions is not None
                and self.instructions.version != self._instruction_version):
            self._instruction_version = self.instructions.version
            self.chunk = None

        if self.chunk is None or self.chunk_pos >= cfg.replan_interval:
            if self.plan_warm_fn is not None and self.chunk is not None:
                prior = shift_prior(self.chunk, self.chunk_pos)
                self.chunk = np.asarray(self.plan_warm_fn(self.window, prior))
            else:
                self.chunk = np.asarray(self.plan_fn(self.window))
            self.chunk_pos = 0
            if cfg.refiner == "bridge" and self.bridge_refine_fn is not None:
                n = min(cfg.refine_horizon, self.chunk.shape[0])
                refined = np.asarray(self.bridge_refine_fn(obs, self.chunk[:n]))
                self.chunk = np.concatenate([refined, self.chunk[n:]], axis=0)
            if cfg.refiner == "lstm":
                self.lstm_carry = None      # a fresh carry per replanned chunk

        action = self.chunk[self.chunk_pos]
        if cfg.refiner == "lstm" and self.lstm_step_fn is not None:
            self.lstm_carry, action = self.lstm_step_fn(
                self.lstm_carry, obs, action, first=self.chunk_pos == 0)
            action = np.asarray(action)

        action = np.array(action, np.float64)
        action[-1] = self.smoother(action[-1])
        self.chunk_pos += 1
        self.t += 1
        return action


class EpisodeReplay:
    """Drive the scheduler from a recorded episode (the harness that takes
    the ROS robot's place): an h5 file where ``h5py`` imports, an npz file
    everywhere (``data/episode.py::EpisodeFile``)."""

    def __init__(self, path: str):
        from vla_touch_tpu_torch.data.episode import EpisodeFile, qpos_from_episode

        self.path = path
        with EpisodeFile(path) as f:
            self.qpos = qpos_from_episode(f)
            self.forces = np.asarray(f["gelsight_force/forces"])
            self.cam1 = np.asarray(f["camera1/camera1"])
            self.cam2 = np.asarray(f["camera2/camera2"])
        self.T = self.qpos.shape[0]

    def instruction(self) -> np.ndarray:
        """The episode's instruction embedding (L, D): the first of
        ``instruct_embeddings``."""
        from vla_touch_tpu_torch.data.episode import EpisodeFile

        with EpisodeFile(self.path) as f:
            return np.asarray(f["instruct_embeddings"])[0]

    def observation(self, t: int) -> Observation:
        t = min(t, self.T - 1)
        return Observation(state=self.qpos[t], images=[self.cam1[t], self.cam2[t], None],
                           force=self.forces[t])

    def run(self, scheduler: ChunkScheduler, steps: Optional[int] = None) -> dict:
        """Closed-loop replay: observations come from the recording; returns
        the executed actions and the tracking MSE, the action at t against
        the recorded state at t + 1."""
        steps = steps or self.T - 1
        actions = np.stack([scheduler.tick(self.observation(t)) for t in range(steps)])
        mse = float(np.mean((actions - self.qpos[1:steps + 1]) ** 2))
        return {"actions": actions, "tracking_mse": mse, "steps": steps}
