"""With the timed path broken underneath, a run comes out not correct:
the harness's look for a card skipped, everything else as a run does it,
at a tiny size on the CPU, against each cell's own limits."""

import pytest
import torch

from benchmark import run as RUN
from benchmark.drivers import serve, train
from benchmark.tests.portbench_tiny import FAKE_DEVICE, tiny_cell

SEED = 2 ** 31 + 77


def _correct(cell, out) -> bool:
    return RUN.result_line(cell, out, False, dict(FAKE_DEVICE))[0]["correct"]


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_sound_serving_is_correct(seed):
    cell = tiny_cell("rdt1b.serve8")
    assert _correct(cell, serve.run(cell, seed, 2.0, False, device="cpu"))


@pytest.mark.parametrize("fault", ["first_action_zeroed", "rows_swapped"])
def test_an_altered_answer_is_not_correct(fault, monkeypatch):
    from vla_touch_tpu_torch.runtime import policy as P

    real = P.policy_step

    def broken(*a, **kw):
        out = real(*a, **kw)
        if fault == "first_action_zeroed":
            out = out.clone()
            out[:, 0] = 0.0
            return out
        return out.flip(0) if out.shape[0] > 1 else out * 1.05

    monkeypatch.setattr(P, "policy_step", broken)
    cell = tiny_cell("rdt1b.serve8")
    assert not _correct(cell, serve.run(cell, SEED, 2.0, False, device="cpu"))


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_sound_training_is_correct(seed):
    cell = tiny_cell("rdt1b.finetune")
    assert _correct(cell, train.run(cell, seed, 1.0, False, device="cpu"))


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.train import rdt_train as T

    def unchanged(rcfg, tcfg, state, batch, draws=None, generator=None, optimizer=None):
        draws = T.train_draws(rcfg, tcfg, state, batch, generator)
        with torch.no_grad():
            loss = R.rdt_compute_loss(rcfg, state.module, {k: v[0] for k, v in batch.items()},
                                      noise=draws["noise"][0], timesteps=draws["timesteps"][0])
        return state, {"loss": loss, "grad_norm": torch.zeros(())}

    monkeypatch.setattr(T, "train_step", unchanged)
    cell = tiny_cell("rdt1b.finetune")
    out = train.run(cell, SEED, 1.0, False, device="cpu")
    assert out["numbers"]["change_gap"] == pytest.approx(1.0)
    assert not _correct(cell, out)


def test_a_small_leaf_left_unmoved_is_not_correct(monkeypatch):
    from vla_touch_tpu_torch.train import rdt_train as T

    real = T.train_step

    def one_leaf_kept(rcfg, tcfg, state, *a, **kw):
        name, p = min(((n, p) for n, p in state.module.named_parameters() if "norm" in n),
                      key=lambda x: x[1].numel())
        kept = p.detach().clone()
        state, metrics = real(rcfg, tcfg, state, *a, **kw)
        with torch.no_grad():
            dict(state.module.named_parameters())[name].copy_(kept)
        return state, metrics

    monkeypatch.setattr(T, "train_step", one_leaf_kept)
    cell = tiny_cell("rdt1b.finetune")
    out = train.run(cell, SEED, 1.0, False, device="cpu")
    assert out["numbers"]["change_gap_own"] == pytest.approx(1.0)
    assert not _correct(cell, out)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from vla_touch_tpu_torch.models.rdt import runner as R

    real = R.rdt_compute_loss

    def half(cfg, module, batch, noise=None, timesteps=None, generator=None):
        h = batch["action_gt"].shape[0] // 2
        return real(cfg, module, {k: v[:h] for k, v in batch.items()}, noise=noise[:h],
                    timesteps=timesteps[:h])

    monkeypatch.setattr(R, "rdt_compute_loss", half)
    cell = tiny_cell("rdt1b.finetune")
    assert not _correct(cell, train.run(cell, SEED, 1.0, False, device="cpu"))
