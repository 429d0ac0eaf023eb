"""Writes ``tests/fixtures/orbax_2proc/``: a JAX train state saved by two
processes through orbax, the layout JAX's multi-process RDT trainer leaves
(``checkpoint-N/state.orbax`` + ``meta.json``), and ``expected.npz``, every
leaf as JAX's ``load_pytree_orbax`` restores it.

Two processes of 4 virtual CPU devices each form one 8-device (4 data x 2
model) mesh over Gloo; they initialise ``rdt_tiny(hidden_size=32,
depth=1)``'s train state into the sharded layout
(``make_sharded_train_step``), take one step (so the Adam moments are not
zero) and save ``{params, ema, opt_state}``.  Each process writes its own
``ocdbt.process_<i>`` database; orbax merges them into the root one.  Then
this process restores the tree on one device and writes the npz.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py

Generated once and committed; the tests only read it.
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "fixtures", "orbax_2proc")
STEP = 1


def _model_cfgs():
    from vla_touch_tpu.config import NoiseSchedulerConfig, TrainConfig, rdt_tiny
    from vla_touch_tpu.models.rdt import runner as R

    rcfg = R.RDTRunnerConfig(model=rdt_tiny(hidden_size=32, depth=1),
                             noise=NoiseSchedulerConfig())
    return rcfg, TrainConfig(grad_accum=1, lr_warmup_steps=0, learning_rate=1e-3)


def _batch(m, micro: int) -> dict:
    rng = np.random.default_rng(21)

    def r(*s):
        return rng.normal(size=(1, micro) + s).astype(np.float32)

    return {"lang_tokens": r(6, m.lang_token_dim),
            "lang_mask": np.ones((1, micro, 6), bool),
            "img_tokens": r(m.img_cond_len, m.img_token_dim),
            "state_tokens": r(1, m.state_token_dim),
            "action_gt": r(m.horizon, m.output_dim),
            "action_mask": np.ones((1, micro, 1, m.output_dim), np.float32),
            "ctrl_freqs": np.full((1, micro), 10.0, np.float32)}


def worker(process_id: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=2,
                               process_id=process_id)
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from vla_touch_tpu.parallel import launch
    from vla_touch_tpu.parallel import mesh as mesh_lib
    from vla_touch_tpu.train import rdt_train as T
    from vla_touch_tpu.utils import checkpoint as ckpt

    rcfg, tcfg = _model_cfgs()
    mesh = mesh_lib.make_mesh(n_data=4, n_model=2)
    step_fn, state_sh = T.make_sharded_train_step(mesh, rcfg, tcfg)
    state = jax.jit(partial(T.init_train_state, rcfg, tcfg),
                    out_shardings=state_sh)(jax.random.PRNGKey(0))
    micro = mesh.shape[mesh_lib.DATA_AXIS]
    batch = _batch(rcfg.model, micro)
    per = micro // 2
    local = {k: v[:, process_id * per:(process_id + 1) * per] for k, v in batch.items()}
    state, _ = step_fn(state, jax.random.PRNGKey(1),
                       launch.host_local_batch(mesh, local, spec=P(None, mesh_lib.DATA_AXIS)))
    path = os.path.join(OUT, f"checkpoint-{STEP}")
    ckpt.save_pytree_orbax(os.path.join(path, "state.orbax"),
                           {"params": state.params, "ema": state.ema.shadow,
                            "opt_state": state.opt_state})
    if process_id == 0:
        ckpt.save_json(os.path.join(path, "meta.json"),
                       {"step": int(state.step), "ema_num_updates": int(state.ema.num_updates)})
    print(f"worker {process_id} saved", flush=True)


def flat(tree, prefix="") -> dict:
    """{'a/b/c': leaf} of a nested dict tree (flax state-dict form)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    shutil.rmtree(OUT, ignore_errors=True)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(i),
                               str(port)], cwd=REPO, env=env) for i in range(2)]
    for p in procs:
        if p.wait(timeout=900) != 0:
            raise SystemExit(f"worker exited with {p.returncode}")

    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from flax import serialization

    from vla_touch_tpu.train import rdt_train as T
    from vla_touch_tpu.utils import checkpoint as ckpt

    rcfg, tcfg = _model_cfgs()
    state = T.init_train_state(rcfg, tcfg, jax.random.PRNGKey(5))
    tree = ckpt.load_pytree_orbax(
        os.path.join(OUT, f"checkpoint-{STEP}", "state.orbax"),
        {"params": state.params, "ema": state.ema.shadow, "opt_state": state.opt_state})
    leaves = flat(serialization.to_state_dict(jax.tree.map(np.asarray, tree)))
    np.savez(os.path.join(OUT, "expected.npz"), **leaves)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"{OUT}: {len(leaves)} leaves, {size} bytes")


if __name__ == "__main__":
    main()
