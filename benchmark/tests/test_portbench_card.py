"""The controls at each cell's own size, on the card: the reference in fp8
put in the program's place must come out not correct, and so must half of
the batch left out.  Run on a card with
``python -m pytest benchmark/tests/test_portbench_card.py -m cuda``; they
skip elsewhere."""

import pytest
import torch

from benchmark import harness as HN
from benchmark import run as RUN

SEEDS = (2 ** 31 + 91, 2 ** 31 + 92, 2 ** 31 + 93)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls run at the cell's own size")


def _correct(cell, numbers) -> bool:
    return HN.Check(numbers, cell["limits"]["limits"]).correct


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_serving_is_not_correct(seed):
    _card()
    from benchmark.drivers import serve

    cell = HN.cell("rdt1b.serve8")
    out = serve.run(cell, seed, 5.0, False, "cuda", control="fp8")
    line, check = RUN.result_line(cell, out, False, HN.device_info(1, out["memory_peak"]))
    print("fp8 serving", seed, check.as_json())
    assert out["failed"] == 0 and not check.correct and not line["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_and_half_batch_training_are_not_correct(seed):
    _card()
    from vla_touch_tpu_torch.data.consumer import collate

    from benchmark import traffic as TR
    from benchmark.drivers import train

    cell = HN.cell("rdt1b.finetune")
    config, traffic = cell["config"], cell["traffic"]
    mb = traffic["recipe"]["batch_size"]
    n = mb * traffic["recipe"]["grad_accum"]
    batches = TR.train_batches(traffic, config, seed, collate)[:traffic["checked_steps"]]
    ref = train.reference_run(config, traffic, seed, batches, n, mb, "cuda")
    fp8 = train.compare(train.reference_run(config, traffic, seed, batches, n, mb, "cuda",
                                            precision="fp8"), ref)
    print("fp8 training", seed, {k: v for k, v in fp8.items() if k != "_left_out"})
    assert not _correct(cell, fp8)
    half = torch.tensor([i for i in range(n) if i % mb < mb // 2])
    got = train.compare(train.reference_run(config, traffic, seed, batches, n, mb // 2, "cuda",
                                            rows=half), ref)
    print("half batch", seed, {k: v for k, v in got.items() if k != "_left_out"})
    assert not _correct(cell, got)
