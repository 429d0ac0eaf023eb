"""Training metrics: a jsonl log (counterpart of
``vla_touch_tpu/utils/metrics.py``, without its TensorBoard mirror)."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, jsonl_name: str = "training.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, jsonl_name)
        self._t0 = time.time()

    def log(self, step: int, scalars: dict, **extra) -> dict:
        row = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in scalars.items()}
        row.update(step=step, elapsed=time.time() - self._t0, **extra)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row

    def close(self):
        """Nothing to release: each record opens and closes the file."""
