"""PyTorch port, the residual controllers against the JAX package (CPU,
float32), part 3: both trainers and evaluations end to end through their
entry points, TF32, the CUDA default and the import guard.  Sizes, helpers
and fixtures: ``tests/torch_controllers_common.py``."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.models.controllers import lstm as TL
from vla_touch_tpu_torch.train import bridge_train as TBT
from vla_touch_tpu_torch.train import lstm_train as TLT

from torch_controllers_common import (  # noqa: F401
    BKW, H, LKW, ROOT, episodes, small_dino,
)


# ---- the entry points, end to end ------------------------------------------------------


def test_trainers_and_evaluations_run_end_to_end_on_the_cpu(tmp_path, episodes, small_dino):
    """Both trainers through their dataset entry points (two epochs, best,
    periodic with pruning, final checkpoints, the jsonl log), then both
    evaluations from the final checkpoints ('vs' and 'bs'); the losses fall,
    and the evaluation of a port-trained BRIDGeR in the JAX package reads
    the same checkpoint."""
    import json

    from vla_touch_tpu_torch.eval import bridge_test as TBE
    from vla_touch_tpu_torch.eval import lstm_step_test as TLE

    ccfg = TC.BridgeControllerConfig(**BKW)
    tcfg = TC.BridgeTrainConfig(horizon=H, batch_size=8, epochs=3, learning_rate=1e-3,
                                val_ratio=0.25)
    out = str(tmp_path / "bridge")
    trainer = TBT.DiffusionControllerTrainer(ccfg, tcfg, out, stats=None, device="cpu")
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule

    dm = ControllerDataModule(episodes, horizon=H, val_ratio=0.25)
    trainer.state.stats = dm.stats
    trainer.train(dm, num_epochs=3, save_interval=1, log_every=1)
    rows = [json.loads(x) for x in open(trainer.metrics_log)]
    assert rows[-1]["loss"] < rows[0]["loss"]
    assert {"best", "checkpoint-1", "checkpoint-2", "checkpoint-3", "final",
            "training.jsonl"} <= set(os.listdir(out))
    final = os.path.join(out, "final")
    assert os.path.exists(os.path.join(final, "image_encoder_dinov2-small.msgpack"))
    st = TB.load_bridge_controller(final, device="cpu")
    for sde in ("vs", "bs"):
        cfg = dataclasses.replace(st.cfg, interpolant=dataclasses.replace(st.cfg.interpolant,
                                                                          sde_type=sde))
        res = TBE.test_diffusion_controller(final, episodes, num_samples=6,
                                            state=dataclasses.replace(st, cfg=cfg), device="cpu")
        assert np.isfinite(res["action_mse"]) and res["num_samples"] == 6
        assert res["inference_dtype"] == "float32"   # the checkpoint's own, on the CPU
    assert JB.load_bridge_controller(final).stats is not None

    lt = TC.LSTMTrainConfig(horizon=H, batch_size=8, epochs=2, learning_rate=1e-3,
                            eval_period_epochs=1, val_ratio=0.25)
    _, ltr = TLT.train_lstm_controller_with_dataset(
        episodes, str(tmp_path / "lstm"), TC.LSTMControllerConfig(**LKW), lt, device="cpu")
    rows = [json.loads(x) for x in open(ltr.metrics_log)]
    assert np.isfinite(rows[-1]["loss"])
    res = TLE.test_lstm_controller(str(tmp_path / "lstm" / "final"), episodes, num_samples=5,
                                   horizon=H, device="cpu")
    assert np.isfinite(res["improvement_pct"])


def test_trainers_turn_tf32_off(tmp_path, small_dino):
    """Both trainers run float32 math: constructing one turns TF32 off for
    CUDA matmuls and cuDNN convolutions (PyTorch's default lets cuDNN's
    convolutions take TF32), whatever the process had set."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    makers = (lambda: TBT.DiffusionControllerTrainer(
                  TC.BridgeControllerConfig(**BKW), TC.BridgeTrainConfig(horizon=H),
                  str(tmp_path / "b"), stats=None, device="cpu"),
              lambda: TLT.LSTMControllerTrainer(
                  TC.LSTMControllerConfig(**LKW), TC.LSTMTrainConfig(horizon=H),
                  str(tmp_path / "l"), stats=None, device="cpu"))
    try:
        for make in makers:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            make()
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_controller_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path,
                                                                     episodes):
    """Without CUDA the trainers, the evaluations and the loaders raise;
    ``device="cpu"`` runs them.  ``--data_format epc`` on a directory that
    holds no ``.epc`` caches raises."""
    from vla_touch_tpu_torch.eval import bridge_test as TBE
    from vla_touch_tpu_torch.eval import lstm_step_test as TLE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data_dir", episodes, "--output_dir", str(tmp_path / "o"), "--horizon", str(H)]
    for fn in (TBT.main, TLT.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(argv)
    for fn in (TBE.main, TLE.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(["--ckpt_path", str(tmp_path), "--data_dir", episodes])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.init_bridge_controller(TC.BridgeControllerConfig(**BKW))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.load_lstm_controller(str(tmp_path))
    st = TB.init_bridge_controller(TC.BridgeControllerConfig(**BKW), device="cpu")
    assert st.module.se_fc1.weight.device.type == "cpu" and st.module.fd_fc1.weight.requires_grad
    with pytest.raises(FileNotFoundError, match=r"\.epc"):
        TBT.main(argv + ["--data_format", "epc"], device="cpu")


def test_controller_modules_import_no_jax():
    """The modules this slice adds import neither JAX, flax, msgpack nor the
    JAX package, and neither does any other module of the port."""
    pat = re.compile(r"^\s*(import (jax|flax|msgpack)|from (jax|flax|msgpack)"
                     r"|.*vla_touch_tpu\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vla_touch_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    for f in files:
        assert not pat.search(open(f).read()), f
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {f"vla_touch_tpu_torch/{m}.py" for m in (
        "utils/checkpoint", "utils/metrics", "utils/ema", "utils/geometry", "data/episode",
        "data/controller_dataset", "models/controllers/lstm", "models/encoders/dinov2_runtime",
        "train/optim", "train/bridge_train", "train/lstm_train", "eval/bridge_test",
        "eval/lstm_step_test")} <= rel
