#!/usr/bin/env python3
"""The JAX package's warm-replan quality protocol
(``tests/test_warm_quality.py``) over several seeds, on the CPU: the
reference for how often the protocol's four asserts pass on a stream,
beside ``tools/torch_warm_quality_seeds.py``'s readings of the port.

    JAX_PLATFORMS=cpu python3 tools/jax_warm_quality_seeds.py [seed ...]

Seed s sets the numpy data stream (``default_rng(s)``), the init key
(``PRNGKey(s)``) and the loss's key (``PRNGKey(s + 1)``); seed 0 is the
test's own stream.  The solver keys are the test's.  Prints one JSON line
per seed (the results, ``passed``, the first failing assert) and a last
line with the count that passed.  Runs on the CPU only (~1-2 min a seed).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def protocol(seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_tiny
    from vla_touch_tpu.models.rdt import runner as R

    spec = importlib.util.spec_from_file_location(
        "jax_warm_quality", os.path.join(ROOT, "tests", "test_warm_quality.py"))
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)

    m = rdt_tiny()
    rcfg = R.RDTRunnerConfig(model=m, noise=NoiseSchedulerConfig())
    rng = np.random.default_rng(seed)
    params = R.init_rdt(rcfg, jax.random.PRNGKey(seed))
    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key, batch):
        loss, g = jax.value_and_grad(lambda p: R.rdt_compute_loss(rcfg, p, key, batch))(params)
        updates, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.PRNGKey(seed + 1)
    first = last = None
    for it in range(900):
        key, k = jax.random.split(key)
        batch = {kk: jnp.asarray(v) for kk, v in T._batch(rng, m, 64)[2].items()}
        params, opt_state, loss = step(params, opt_state, k, batch)
        if it == 0:
            first = float(loss)
        last = float(loss)

    B = 16
    phase = T._batch(rng, m, B, t=np.full((B,), 20.0))[0]

    def chunks_at(t, prior=None, skip=0, key_seed=3):
        b = T._batch(rng, m, B, phase=phase, t=t)[2]
        return np.asarray(R.rdt_predict_action(
            rcfg, params, jax.random.PRNGKey(key_seed), jnp.asarray(b["lang_tokens"]),
            jnp.asarray(b["lang_mask"]), jnp.asarray(b["img_tokens"]),
            jnp.asarray(b["state_tokens"]), jnp.asarray(b["action_mask"]),
            jnp.asarray(b["ctrl_freqs"]),
            prior_chunk=None if prior is None else jnp.asarray(prior), skip_steps=skip))

    S = T.SHIFT
    cold_mses, warm_mses, prior_mses = [], [], []
    chunk = chunks_at(np.full((B,), 20.0))
    for i in range(4):
        t_next = np.full((B,), 20.0 + (i + 1) * S)
        gt = T._chunk_gt(phase, t_next)
        prior = np.concatenate([chunk[:, S:], np.repeat(chunk[:, -1:], S, axis=1)], axis=1)
        cold = chunks_at(t_next, key_seed=10 + i)
        warm = chunks_at(t_next, prior=prior, skip=2, key_seed=10 + i)
        cold_mses.append(T._mse(cold, gt))
        warm_mses.append(T._mse(warm, gt))
        prior_mses.append(T._mse(prior, gt))
        chunk = warm
    gt_var = float(np.mean(np.square(T._chunk_gt(phase, np.full((B,), 22.0))[..., :T.ADIM])))
    return {"first_loss": first, "last_loss": last, "cold_mse": float(np.mean(cold_mses)),
            "warm_mse": float(np.mean(warm_mses)), "prior_mse": float(np.mean(prior_mses)),
            "signal_power": gt_var}


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from vla_touch_tpu_torch.eval import warm_quality as WQ

    seeds = [int(a) for a in argv] or [0]
    passed = 0
    for seed in seeds:
        r = protocol(seed)
        try:
            WQ.check(r)
            failed = None
        except AssertionError as e:
            failed = str(e)
        passed += failed is None
        print(json.dumps(dict(seed=seed, device="cpu", package="jax", passed=failed is None,
                              failed_assert=failed,
                              cold_over_signal=r["cold_mse"] / r["signal_power"], **r)),
              flush=True)
    print(json.dumps(dict(passed=passed, runs=len(seeds), device="cpu", package="jax")),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
