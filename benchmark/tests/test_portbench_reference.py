"""The plain reference against the program at a tiny size on the CPU, and
the weights' way into the program."""

import os

import torch

from benchmark import harness as HN
from benchmark.drivers import common as C
from benchmark.drivers import serve, train
from benchmark.reference import model as M
from benchmark.tests.portbench_tiny import tiny_cell, tiny_config

SEED = 2 ** 31 + 4242


def test_frozen_manifests_are_the_reference_shapes():
    man = os.path.join(HN.HERE, "reference", "manifests")
    cfg = HN.read_json(os.path.join(HN.HERE, "configs", "rdt1b.json"))
    assert M.rdt_shapes(cfg["rdt"]) == HN.read_json(os.path.join(man, "rdt_1b.json"))
    sig = HN.read_json(os.path.join(man, "siglip_so400m.json"))
    shapes = M.siglip_shapes(cfg["vision"])
    assert all(sig[k] == v for k, v in shapes.items())
    # only the attention-pool head, which the tower does not use, is left
    assert all(".head." in k for k in set(sig) - set(shapes))


def test_no_weight_is_silent():
    w = C.rdt_weights(tiny_config(), SEED, "cpu", torch.float32)
    assert all(bool((t != 0).any()) for t in w.values())
    assert float(w["model.final_layer.ffn_final.fc2.weight"].abs().mean()) > 1e-3


def test_weights_reach_the_program_through_its_loaders():
    config = tiny_config()
    rdt, vision, mapping = C.modules(config, SEED, "cpu", torch.float32)
    hf = C.rdt_weights(config, SEED, "cpu", torch.float32)
    own = rdt.state_dict()
    assert len(mapping) == len(hf) == len(own)
    for name, (src, order) in mapping.items():
        assert order is None and torch.equal(own[name], hf[src].reshape(own[name].shape))
    # SigLIP's patch convolution becomes the program's Linear over (ky, kx, c)
    sig = C.siglip_weights(config, SEED, "cpu", torch.float32)
    img = torch.rand(2, 28, 28, 3)
    want = torch.nn.functional.conv2d(img.permute(0, 3, 1, 2),
                                      sig["vision_model.embeddings.patch_embedding.weight"],
                                      sig["vision_model.embeddings.patch_embedding.bias"], stride=14)
    got = vision.vit.embed(img) - vision.vit.pos_embed
    assert torch.allclose(got, want.flatten(2).transpose(1, 2), atol=1e-5)


def test_served_chunks_match_the_program():
    cell = tiny_cell("rdt1b.serve8")
    out = serve.run(cell, SEED, 2.0, False, device="cpu")
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["numbers"]["chunk_rel_gap"] < 1e-5
    # the fp8 reference in the program's place is judged instead, and far off
    low = serve.run(cell, SEED, 2.0, False, device="cpu", control="fp8")
    assert low["numbers"]["chunk_rel_gap"] > 100 * out["numbers"]["chunk_rel_gap"]


def test_training_steps_match_the_program():
    out = train.run(tiny_cell("rdt1b.finetune"), SEED, 1.0, False, device="cpu")
    n = out["numbers"]
    assert out["attempted"] >= 1
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5 and n["change_gap"] < 1e-3, n
    assert n["grad_gap_own"] < 1e-5 and n["change_gap_own"] < 1e-3, n
