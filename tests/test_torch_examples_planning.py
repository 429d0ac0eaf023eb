"""PyTorch port, the README's planning walkthrough
(``examples/torch_planning_pipeline.py``) against the JAX package's
(``examples/planning_pipeline.py``) on the CPU: the greedy ``test_llm``
predictions token for token and the best-of-n reasoning record, with the
JAX walkthrough's trained encoder, decoder, projector and LoRA carried
across by the converter (``utils/from_flax.py``); then the port's
walkthrough end to end at 2 epochs, as ``tests/test_examples.py`` runs
JAX's.  The full walkthrough: ``tests/test_torch_examples.py``.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.models.encoders.vit import ViTConfig as JViT
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def planning(tmp_path_factory):
    """The planning walkthrough's JAX side at 2 epochs (the tiny CLIP from
    ``PRNGKey(0)``, ``qwen2_tiny`` from ``PRNGKey(1)``, projector + LoRA
    trained) and the port's copies of the encoder, decoder, projector and
    LoRA; the synthetic videos and QA file the port walkthrough writes."""
    TW = _example("torch_planning_pipeline")
    from vla_touch_tpu.planning import encoder as JPE
    from vla_touch_tpu.planning import llm as JLL
    from vla_touch_tpu.planning import run_llm as JRL
    from vla_touch_tpu.planning.datasets import TactileLLMDataset as JDS

    root = tmp_path_factory.mktemp("plan")
    videos = TW.synthetic_videos(str(root))
    chat = TW.reasoning_chat()
    prompt = JRL.render_chat(chat[:-1]).replace("<tact_tokens>", "<tact>")
    qa = str(root / "qa.json")
    with open(qa, "w") as f:
        json.dump(TW.qa_rows(videos, prompt), f)
    clip = dict(hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64, patch_size=16,
                image_size=32, use_layerscale=False, quick_gelu=True, use_pre_norm=True,
                layernorm_eps=1e-5, patch_bias=False)
    jst = JPE.init_tactile_encoder(JViT(**clip), jax.random.PRNGKey(0))
    jcfg = JLL.qwen2_tiny(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
                          num_kv_heads=2, mlp_dim=128)
    jparams = JLL.init_llm(jcfg, jax.random.PRNGKey(1))
    jp, jl = JRL.train_projection_and_lora(jst, jcfg, jparams, JDS([qa], split_name="train"),
                                           str(root / "jax_out"), epochs=2, lr=3e-3,
                                           lora_rank=8, frame_size=32)
    from vla_touch_tpu_torch.planning import llm as TLL

    tcfg = TLL.qwen2_tiny(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
                          num_kv_heads=2, mlp_dim=128)
    return dict(root=root, videos=videos, chat=chat, qa=qa, jst=jst, jcfg=jcfg,
                jparams=jparams, jp=jp, jl=jl, tcfg=tcfg, JRL=JRL, JDS=JDS,
                tst=FF.tactile_encoder(jst, device="cpu"),
                tparams=FF.llm(jparams, tcfg, device="cpu"),
                tp=FF.tactile_projector(jp, device="cpu"), tl=FF.llm_lora(jl, device="cpu"))


def test_planning_greedy_predictions_match_jax(planning):
    """Stage 4 of the planning walkthrough: ``test_llm`` (12 new tokens)
    with JAX's trained projector and LoRA carried across decodes JAX's
    prediction token for token."""
    from vla_touch_tpu_torch.planning import run_llm as TRL
    from vla_touch_tpu_torch.planning.datasets import TactileLLMDataset as TDS

    p, root = planning, planning["root"]
    jif = p["JRL"].make_llm_interface(p["jcfg"], p["jparams"], lora=p["jl"], max_new_tokens=12)
    tif = TRL.make_llm_interface(p["tcfg"], p["tparams"], lora=p["tl"], max_new_tokens=12)
    want = p["JRL"].test_llm(p["jst"], jif, p["jp"], p["JDS"]([p["qa"]], split_name="test"),
                             str(root / "jtest"), frame_size=32)
    got = TRL.test_llm(p["tst"], tif, p["tp"], TDS([p["qa"]], split_name="test"),
                       str(root / "ttest"), frame_size=32)
    assert len(got) == 1 and isinstance(got[0]["prediction"], str)
    tok = tif.tokenizer
    assert [tok.encode(r["prediction"]) for r in got] == [tok.encode(r["prediction"])
                                                          for r in want]


def test_planning_best_of_n_selects_as_jax(planning):
    """Stage 5: ``reason_llm`` best-of-n (4 samples at temperature 0.15)
    on the same sampled generations, JAX's, passed to both packages' sample
    call: the final prompt's spliced embeddings within 1e-5 of JAX's, and
    the same record (final generation, option counts and scores, the true
    answer "A", 4 samples)."""
    from vla_touch_tpu_torch.planning import run_llm as TRL

    p, root = planning, planning["root"]
    jif = p["JRL"].make_llm_interface(p["jcfg"], p["jparams"], lora=p["jl"], max_new_tokens=12)
    tif = TRL.make_llm_interface(p["tcfg"], p["tparams"], lora=p["tl"], max_new_tokens=12)
    rows = [{"info": {"scenario": "sorting", "target": "sponge",
                      "tactile": [p["videos"]["sponge"]],
                      "objects": {"Object 1": "sponge"}, "num_candidates": 2},
             "chat": p["chat"]}]
    # JAX's own two samples, then two that parse to options, so that the
    # selection has options to score
    parsed = [{"text": "A) sponge. Answer: A", "avg_surprisal": 2.5, "total_surprisal": 50.0},
              {"text": "Answer: B", "avg_surprisal": 1.0, "total_surprisal": 9.0}]
    seen, sampled = {}, jif.sample_fn

    def jax_sample(embeds, num, temperature, seed=0):
        seen["jax"] = (np.asarray(embeds, np.float32), num, temperature, seed)
        seen["cands"] = sampled(embeds, num, temperature, seed)[:num - len(parsed)] + parsed
        return seen["cands"]

    def port_sample(embeds, num, temperature, seed=0):
        seen["port"] = (np.asarray(embeds, np.float32), num, temperature, seed)
        return seen["cands"]

    jif.sample_fn, tif.sample_fn = jax_sample, port_sample
    kw = dict(reasoning_sampling_num=4, reasoning_temperature=0.15,
              reasoning_selection_type="best_of_n", generate_idx=(), frame_size=32)
    want = p["JRL"].reason_llm(p["jst"], jif, p["jp"], rows, str(root / "jreason"), **kw)
    got = TRL.reason_llm(p["tst"], tif, p["tp"], rows, str(root / "treason"), **kw)
    (je, jn, jt, js), (te, tn, tt, ts) = seen["jax"], seen["port"]
    assert (tn, tt, ts) == (jn, jt, js) == (4, 0.15, 0)
    np.testing.assert_allclose(te, je, atol=1e-5, rtol=1e-5)
    w, g = want["sorting_sponge"][0], got["sorting_sponge"][0]
    assert g["final_true_answer"] == "A" and g["reasoning_sampling_num"] == 4
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], float):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
        else:
            assert g[k] == w[k], k



def test_planning_walkthrough_runs_end_to_end_on_the_cpu(tmp_path):
    """``examples/torch_planning_pipeline.py`` at 2 epochs on the CPU, with
    ``tests/test_examples.py``'s assertions on the JAX walkthrough."""
    wd = str(tmp_path / "demo")
    _example("torch_planning_pipeline").main(wd, epochs=2, device="cpu")
    out = os.path.join(wd, "llm_out")
    preds = json.load(open(os.path.join(out, "predictions.json")))
    assert len(preds) == 1 and isinstance(preds[0]["prediction"], str)
    rec = json.load(open(os.path.join(out, "reason", "sorting_sponge.json")))[0]
    assert rec["final_true_answer"] == "A"
    assert rec["reasoning_sampling_num"] == 4
    assert os.path.exists(os.path.join(out, "llm_training.jsonl"))
