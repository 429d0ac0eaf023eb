"""The traffic is a function of the seed, and every seed does the same work."""

import numpy as np

from benchmark import traffic as TR
from benchmark.tests.portbench_tiny import tiny_cell

BIG_SEED = 2 ** 31 + 987654321


def _same(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_serve_requests_follow_the_seed():
    cell = tiny_cell("rdt1b.serve8")
    a = TR.serve_requests(cell["traffic"], cell["config"], BIG_SEED)
    b = TR.serve_requests(cell["traffic"], cell["config"], BIG_SEED)
    c = TR.serve_requests(cell["traffic"], cell["config"], BIG_SEED + 1)
    assert _same(a, b)
    assert not _same(a, c)
    # the same lengths, in another order
    assert sorted(len(r["text_mask"]) for r in a) == sorted(len(r["text_mask"]) for r in c)
    assert len({r["proprio"].tobytes() for r in a}) == len(a)


def test_train_batches_follow_the_seed():
    from vla_touch_tpu_torch.data.consumer import collate

    cell = tiny_cell("rdt1b.finetune")
    a = TR.train_batches(cell["traffic"], cell["config"], BIG_SEED, collate)
    b = TR.train_batches(cell["traffic"], cell["config"], BIG_SEED, collate)
    c = TR.train_batches(cell["traffic"], cell["config"], 7, collate)
    keys = [k for k in a[0] if k != "dataset_names"]
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in keys)
    assert not all(np.array_equal(x[k], y[k]) for x, y in zip(a, c) for k in keys)
    assert [sorted(x["lang_mask"].sum(1)) for x in a] == [sorted(x["lang_mask"].sum(1)) for x in c]
    rows = np.concatenate([x["action_gt"] for x in a]).reshape(-1, 8 * 128)
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert a[0]["lang_tokens"].shape[1] == cell["config"]["rdt"]["max_lang_cond_len"]


def test_sub_seeds_take_large_seeds():
    seeds = {TR.sub_seed(s, "pool") for s in (0, 1, 2 ** 31, 2 ** 31 + 1, 2 ** 40)}
    assert len(seeds) == 5
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert TR.sub_seed(5, "pool") != TR.sub_seed(5, "draws")
