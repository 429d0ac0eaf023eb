"""The check that no run loaded JAX or the JAX package: whole top-level
names, so the port (whose name begins with the JAX package's) passes."""

import os
import subprocess
import sys

from benchmark import harness as HN


def test_banned_names_are_whole_top_level_words():
    mods = {n: None for n in ("vla_touch_tpu_torch", "vla_touch_tpu_torch.runtime.policy",
                              "jaxtyping", "flaxen", "numpy")}
    assert HN.banned_modules(mods) == []
    planted = dict(mods, **{n: None for n in ("vla_touch_tpu", "vla_touch_tpu.ops.nn", "jax",
                                              "jaxlib.xla_client", "flax.linen", "optax")})
    assert HN.banned_modules(planted) == ["flax.linen", "jax", "jaxlib.xla_client", "optax",
                                          "vla_touch_tpu", "vla_touch_tpu.ops.nn"]


_RUN = r"""
import sys
sys.path.insert(0, {root!r})
import torch
from benchmark import harness as HN
from benchmark import run

torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
HN.device_info = lambda count, peak: {{"platform": "gpu", "kind": "x", "count": count,
                                      "memory_peak_bytes": peak}}


class Driver:
    @staticmethod
    def run(cell, seed, seconds, trace, device):
        {plant}
        return {{"e2e": {{"setup_s": 1.0, "chunks_per_s": 1.0}},
                 "ctx": {{}}, "numbers": {{"chunk_rel_gap": 0.0}}, "attempted": 1,
                 "failed": 0, "memory_peak": 0, "errors": []}}


HN.driver = lambda kind: Driver
sys.exit(run.main(["--workload", "rdt1b.serve8", "--seed", "1", "--seconds", "1"]))
"""


def _run_with(plant):
    code = _RUN.format(root=HN.ROOT, plant=plant)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)


def test_a_planted_import_of_the_jax_package_fails_the_run():
    # a stand-in module under the JAX package's name (importing the package
    # itself would bring up JAX)
    p = _run_with("import types; sys.modules['vla_touch_tpu.ops'] = types.ModuleType('x')")
    assert p.returncode == 3, p.stderr[-2000:]
    assert p.stdout.strip() == ""
    assert "vla_touch_tpu" in p.stderr


def test_the_port_passes():
    p = _run_with("import vla_touch_tpu_torch.runtime.policy")
    assert p.returncode == 0, p.stderr[-2000:]
    assert '"correct": true' in p.stdout.strip().splitlines()[-1]
