"""PyTorch port, the episode data tools against the JAX package on the same
inputs (CPU): the capture pipeline (instructions, T5 embeddings, GelSight
force, episode files), the batch tools, the VLA distillation pass, the
dataset statistics and the capture labeler / GelSight reviewer.

Tolerances: T5 embeddings 2e-5 abs (``tests/test_torch_encoders.py``'s
float32 bound: the same arithmetic in another order); forces and
displacements within 0.5 px of JAX's (the tracker tests' bound; the
same float32 arithmetic in another order measures below 1e-5); the
distilled chunks atol 1e-5 / rtol 1e-4 (``tests/test_torch_slice.py``'s
chunk bound); statistics 1e-6 relative (float32 rounding of the 6-D
rotation code in the port's numpy against XLA); frames, files and
listings exactly.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from tests.test_marker_tracking import CFG as JAX_TRACK_CFG
from tests.test_marker_tracking import make_marker_frame
from vla_touch_tpu.data import capture as JC
from vla_touch_tpu.data import episode as JE
from vla_touch_tpu.runtime import native_loader as JN
from vla_touch_tpu_torch.data import capture as TC
from vla_touch_tpu_torch.data import episode as TE
from vla_touch_tpu_torch.ops import marker_tracking as TM

T = 6


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library(tmp_path_factory):
    """JAX's episode-cache library built into this module's temporary
    directory: JAX's build writes beside its source without a lock, and
    other test modules may build it there at the same time."""
    saved = JN._LIB_PATH, JN._lib
    JN._LIB_PATH = str(tmp_path_factory.mktemp("jax_native") / "libepisode_cache.so")
    JN._lib = None
    yield
    JN._LIB_PATH, JN._lib = saved


class ByteTok:
    """Bytes folded into the tiny vocabulary, EOS (1) appended."""

    def __call__(self, text, truncation=True, max_length=1024):
        ids = [b % 120 + 3 for b in text.encode()][: max_length - 1] + [1]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


@pytest.fixture(scope="module")
def t5_embedders():
    """JAX's and the port's native T5 embedder on one 2-layer ``t5_tiny``
    in float32, the port's weights converted from the flax tree."""
    from vla_touch_tpu.models.encoders import t5_native as JT
    from vla_touch_tpu_torch.models.encoders import t5_native as TT
    from vla_touch_tpu_torch.utils import from_flax as FF

    jcfg, tcfg = JT.t5_tiny(), TT.t5_tiny()
    assert jcfg.num_layers == tcfg.num_layers == 2
    params = jax.tree.map(np.asarray, JT.init_t5_encoder(jcfg, jax.random.PRNGKey(5)))
    with torch.device("meta"):
        module = TT.T5Encoder(tcfg)
    module = FF.load_into(module.to_empty(device="cpu"), FF.t5_encoder(params))
    return (JT.NativeT5Embedder(jcfg, params, ByteTok(), dtype=jnp.float32),
            TT.NativeT5Embedder(tcfg, module.eval().requires_grad_(False), ByteTok(),
                                dtype=torch.float32, device="cpu"))


def _write_capture(root):
    """``tests/test_tools.py``'s capture directory: 24^2 camera frames,
    GelSight frames whose markers shift 1 px a frame, random poses."""
    import cv2

    epi = root / "ep0"
    for sub in ("camera1", "camera2", "gelsight"):
        (epi / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(T):
        img = (np.linspace(0, 255, 24 * 24 * 3).reshape(24, 24, 3) + 10 * t).clip(0, 255)
        img = img.astype(np.uint8)
        cv2.imwrite(str(epi / "camera1" / f"{t:06d}.jpg"), img[:, :, ::-1])
        cv2.imwrite(str(epi / "camera2" / f"{t:06d}.jpg"), img[:, :, ::-1])
        gel = make_marker_frame((t * 1.0, 0.0)).astype(np.uint8)
        cv2.imwrite(str(epi / "gelsight" / f"{t:06d}.jpg"), np.stack([gel] * 3, -1))
    np.save(str(epi / "ee_poses.npy"), rng.normal(size=(T, 7)).astype(np.float64))
    np.save(str(epi / "gripper_pos.npy"), np.full(T, 128.0))
    return epi


@pytest.fixture(scope="module")
def captures(tmp_path_factory, t5_embedders):
    """One capture directory, copied; JAX's steps 1-4 on one copy, the
    port's on the other (episodes written as h5 and npz)."""
    jemb, temb = t5_embedders
    base = tmp_path_factory.mktemp("capture")
    _write_capture(base / "src")
    out = {}
    for name, mod, emb, kw in (("jax", JC, jemb, {}), ("port", TC, temb, {"device": "cpu"})):
        root = base / name
        shutil.copytree(base / "src", root)
        mod.label_instructions(str(root), {"ep0": "wipe the table"})
        out[f"{name}_lang"] = mod.precompute_instructions(str(root), emb)
        out[f"{name}_force"] = mod.process_gelsight(str(root / "ep0"), **kw)
        out[f"{name}_h5"] = mod.convert_to_hdf5(str(root / "ep0"), str(base / f"{name}.h5"))
        out[f"{name}_dir"] = root / "ep0"
    out["port_npz"] = TC.convert_to_hdf5(str(out["port_dir"]), str(base / "port.npz"))
    return out


def test_capture_instructions_embed_as_jax(captures):
    assert [os.path.basename(p) for p in captures["port_lang"]] == ["instruct_lang.npy"]
    assert (captures["port_dir"] / "instruction.txt").read_text() == "wipe the table\n"
    got = np.load(captures["port_lang"][0])
    want = np.load(captures["jax_lang"][0])
    assert got.shape == want.shape == (len("wipe the table") + 1, 32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_capture_force_matches_jax(captures):
    got, want = captures["port_force"], captures["jax_force"]
    assert got["forces"].shape == (T, 3) and got["forces"].dtype == np.float32
    assert np.abs(got["forces"] - want["forces"]).max() <= 0.5
    assert np.abs(got["displacements"] - want["displacements"]).max() <= 0.5
    # the markers shift ~1 px a frame: the recovered x displacement follows
    np.testing.assert_allclose(got["displacements"][:, 0], np.arange(T), atol=0.5)
    for name in ("forces", "displacement"):
        np.testing.assert_array_equal(
            np.load(captures["port_dir"] / "gelsight_force" / f"{name}.npy"),
            got["forces" if name == "forces" else "displacements"])


def test_capture_episode_files_equal_jax(captures):
    import h5py

    with h5py.File(captures["jax_h5"]) as jf, TE.EpisodeFile(captures["port_h5"]) as h5, \
            TE.EpisodeFile(captures["port_npz"]) as npz:
        for key in ("ee_poses", "gripper_pos", "camera1/camera1", "camera2/camera2",
                    "instruct_embeddings"):
            want = np.asarray(jf[key])
            for f in (h5, npz):
                got = np.asarray(f[key])
                assert got.shape == want.shape and got.dtype == want.dtype, key
                if key == "instruct_embeddings":
                    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=key)
        for key in ("gelsight_force/forces", "gelsight_force/displacement"):
            np.testing.assert_array_equal(np.asarray(h5[key]), np.asarray(npz[key]))
            assert np.abs(np.asarray(h5[key]) - np.asarray(jf[key])).max() <= 0.5
        assert np.asarray(npz["camera1/camera1"]).shape == (T, 24, 24, 3)


def test_capture_gelsight_needs_cuda_unless_asked_for_the_cpu(captures, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.process_gelsight(str(captures["port_dir"]))


def _episode_tree(root):
    for i in range(4):
        d = root / f"episode_{i}" / "camera1"
        d.mkdir(parents=True)
        (d / "old.jpg").write_bytes(b"x")
    (root / "notes").mkdir()


def _listing(root):
    out = []
    for d, _, names in sorted(os.walk(root)):
        for n in sorted(names):
            p = os.path.join(d, n)
            out.append((os.path.relpath(p, root), open(p, "rb").read()))
    return out


def test_batch_tools_match_jax(tmp_path):
    results = {}
    for name, mod in (("jax", JC), ("port", TC)):
        root = tmp_path / name
        _episode_tree(root)
        results[name] = [
            mod.batch_rename_files(str(root), (1, 2), "old.jpg", "new.jpg", subfolder="camera1"),
            mod.batch_rename_files(str(root), (0, 3), "old.jpg", "new.jpg", subfolder="camera1"),
            mod.batch_create_instructions(str(root), (2, 3), "wipe the plate"),
            _listing(root)]
    assert results["port"] == results["jax"]
    assert results["port"][:3] == [{"renamed": 2, "not_found": 0},
                                   {"renamed": 2, "not_found": 2}, 2]


# ---- the distillation pass -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_policies():
    """JAX's tiny policy (``rdt_tiny`` float32, 3 solver steps, a 1-layer
    28^2 ViT) and the port's on the same weights (``tests/test_torch_slice.py``'s
    golden configuration)."""
    from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_tiny
    from vla_touch_tpu.models.encoders.vit import ViTConfig
    from vla_touch_tpu.models.rdt import runner as R
    from vla_touch_tpu.runtime import policy as P
    from vla_touch_tpu_torch import config as TCFG
    from vla_touch_tpu_torch.models.encoders import vit as TV
    from vla_touch_tpu_torch.models.rdt import runner as TR
    from vla_touch_tpu_torch.runtime import policy as TP
    from vla_touch_tpu_torch.utils import from_flax as FF

    vit_kw = dict(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
                  patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)
    cfg = P.PolicyConfig(rdt=R.RDTRunnerConfig(model=rdt_tiny(dtype="float32"),
                                               noise=NoiseSchedulerConfig(
                                                   num_inference_timesteps=3)),
                         vision=ViTConfig(**vit_kw), image_size=28)
    jmodel = P.create_model(cfg, seed=0)
    fc2 = jmodel.rdt_params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(np.random.default_rng(1).normal(size=fc2["kernel"].shape)
                                * 0.05, jnp.float32)
    tcfg = TP.PolicyConfig(rdt=TR.RDTRunnerConfig(model=TCFG.rdt_tiny(dtype="float32"),
                                                  noise=TCFG.NoiseSchedulerConfig(
                                                      num_inference_timesteps=3)),
                           vision=TV.ViTConfig(**vit_kw), image_size=28)
    rdt = FF.load_into(TR.RDTRunnerModule(tcfg.rdt.model), FF.rdt_runner(jmodel.rdt_params))
    vision = FF.load_into(TV.SiglipVisionEncoder(tcfg.vision), FF.vit(jmodel.vision_params))
    tmodel = TP.RoboticDiffusionTransformerModel(tcfg, rdt.eval().requires_grad_(False),
                                                 vision.eval().requires_grad_(False))
    return cfg, jmodel, tmodel


def _jax_noises(seed: int, n: int, shape) -> list:
    """The starting noise of each of ``n`` JAX ``step`` calls from the key
    ``PRNGKey(seed)``: the second half of each split."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float32))))
    return out


@pytest.fixture(scope="module")
def distilled(tmp_path_factory, tiny_policies):
    """One episode (T 10, 24^2 frames, 32-wide language) distilled by JAX
    (h5) and by the port (h5 and npz) at image_size 32."""
    from vla_touch_tpu.data.distill import record_vla_actions_for_episode as jax_distill
    from vla_touch_tpu_torch.data.distill import record_vla_actions_for_episode

    cfg, jmodel, tmodel = tiny_policies
    root = tmp_path_factory.mktemp("distill")
    kw = dict(num_steps=10, img_size=24, chunk=4, lang_dim=32, with_vla=False)
    JE.write_synthetic_episode(str(root / "ep.h5"), **kw)
    TE.write_synthetic_episode(str(root / "ep.npz"), **kw)
    m = cfg.rdt.model
    jmodel._key = jax.random.PRNGKey(99)
    out = {"jax": jax_distill(str(root / "ep.h5"), str(root / "jax.h5"), jmodel.step,
                              image_size=32)}
    calls = {}
    for fmt in ("h5", "npz"):
        noises = iter(_jax_noises(99, 10, (1, m.horizon, m.output_dim)))
        calls[fmt] = []

        def step(proprio, images, text, fmt=fmt, noises=noises):
            calls[fmt].append([None if im is None else im.shape for im in images])
            return tmodel.step(proprio, images, text, init_noise=next(noises))

        tmodel.reset()
        out[fmt] = record_vla_actions_for_episode(str(root / f"ep.{fmt}"),
                                                  str(root / f"port.{fmt}"), step,
                                                  image_size=32)
    out["calls"] = calls
    return out


def test_distillation_matches_jax(distilled):
    import h5py

    assert distilled["npz"].endswith(".npz") and distilled["h5"].endswith(".h5")
    for fmt in ("h5", "npz"):
        calls = distilled["calls"][fmt]
        assert len(calls) == 10
        assert all(c == [(24, 24, 3)] * 2 + [None] + [(24, 24, 3)] * 2 + [None] for c in calls)
    with h5py.File(distilled["jax"]) as jf, TE.EpisodeFile(distilled["h5"]) as h5, \
            TE.EpisodeFile(distilled["npz"]) as npz:
        want = np.asarray(jf["vla_action"])
        for f in (h5, npz):
            got = np.asarray(f["vla_action"])
            assert got.shape == (10, 8, 10) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
            for key in ("camera1_resized", "camera2_resized"):
                np.testing.assert_array_equal(np.asarray(f[key]), np.asarray(jf[key]))
            # the source keys are carried over
            np.testing.assert_array_equal(np.asarray(f["camera1/camera1"]),
                                          np.asarray(jf["camera1"]["camera1"]))
        np.testing.assert_array_equal(np.asarray(h5["vla_action"]), np.asarray(npz["vla_action"]))
        assert np.asarray(npz["camera2_resized"]).shape == (10, 32, 32, 3)


def test_distilled_dataset_pass_writes_each_format(tmp_path):
    """``record_vla_actions_for_dataset`` over a directory of both formats."""
    from vla_touch_tpu_torch.data.distill import record_vla_actions_for_dataset

    src = tmp_path / "in"
    JE.write_synthetic_episode(str(src / "episode_0.h5"), num_steps=4, img_size=16,
                               chunk=4, lang_dim=8, with_vla=False)
    TE.write_synthetic_episode(str(src / "episode_1.npz"), num_steps=4, img_size=16,
                               chunk=4, lang_dim=8, with_vla=False)

    def step(proprio, images, text):
        return np.tile(np.asarray(proprio, np.float32)[None, None], (1, 4, 1))

    outs = record_vla_actions_for_dataset(str(src), str(tmp_path / "out"), step, image_size=16)
    assert [os.path.basename(p) for p in outs] == ["episode_0.h5", "episode_1.npz"]
    for p in outs:
        with TE.EpisodeFile(p) as f:
            np.testing.assert_allclose(np.asarray(f["vla_action"])[2, 0],
                                       TE.qpos_from_episode(f)[2].astype(np.float32))


# ---- dataset statistics ----------------------------------------------------------------


@pytest.mark.parametrize("data_format", ["h5", "epc"])
def test_dataset_stats_match_jax(tmp_path, data_format):
    from vla_touch_tpu.config import DataConfig as JDC
    from vla_touch_tpu.data import stats as JS
    from vla_touch_tpu.data.vla_dataset import UnifiedVLADataset as JDS
    from vla_touch_tpu_torch.config import DataConfig
    from vla_touch_tpu_torch.data import stats as TS
    from vla_touch_tpu_torch.data.pack_epc import pack_dataset
    from vla_touch_tpu_torch.data.vla_dataset import UnifiedVLADataset

    d = tmp_path / "mango_hdf5_gelsight"
    JE.make_synthetic_dataset(str(d), n_episodes=2, num_steps=48, img_size=28, chunk=8,
                              lang_dim=16)
    if data_format == "epc":
        pack_dataset(str(d), codec="raw")
        for p in d.glob("*.h5"):
            p.unlink()
    kw = dict(data_root=str(tmp_path), chunk_size=8, data_format=data_format)
    files = TE.list_episode_files(str(d), pattern=(".epc",) if data_format == "epc"
                                  else (".h5",))
    got = TS.compute_dataset_stat(UnifiedVLADataset(DataConfig(**kw), file_paths=files))
    want = JS.compute_dataset_stat(JDS(JDC(**kw), file_paths=files))
    assert got["num_steps"] == want["num_steps"] > 0
    for k in ("state_mean", "state_std", "state_min", "state_max", "nonzero_fraction"):
        assert got[k].shape == (128,) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert got["state_std"][100] == 0.0 and got["nonzero_fraction"][30] > 0.9

    out = TS.process_dataset(DataConfig(**kw), str(tmp_path / "port.json"))
    ref = JS.process_dataset(JDC(**kw), str(tmp_path / "jax.json"))
    assert set(out) == set(ref) == {"mango"}
    back = json.load(open(tmp_path / "port.json"))
    for k, v in ref["mango"].items():
        np.testing.assert_allclose(np.asarray(back["mango"][k]), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# ---- the labeler and the GelSight reviewer (tests/test_label_tool.py's flows) ----------


def _write_frames(d, frames):
    import cv2

    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        img = np.asarray(f)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        cv2.imwrite(os.path.join(d, f"{i:06d}.jpg"), img.astype(np.uint8))


@pytest.fixture
def capture_root(tmp_path):
    root = str(tmp_path / "capture")
    rng = np.random.default_rng(0)
    for e in range(2):
        d = os.path.join(root, f"episode_{e}")
        _write_frames(os.path.join(d, "camera1"),
                      rng.integers(0, 255, size=(4, 48, 64, 3)).astype(np.uint8))
        _write_frames(os.path.join(d, "gelsight"),
                      [make_marker_frame((0.0, 0.0)), make_marker_frame((2.0, 1.0)),
                       make_marker_frame((4.0, 2.0))])
    return root


def test_labeler_scripted_flow(capture_root):
    from vla_touch_tpu_torch.data import label_tool as LT

    answers = iter(["wipe the table with the sponge", "="])
    shown = []
    labeled = LT.run_labeler(capture_root, input_fn=lambda _: next(answers),
                             print_fn=shown.append)
    assert len(labeled) == 2
    for d, text in labeled.items():
        assert text == "wipe the table with the sponge"
        with open(os.path.join(d, "instruction.txt")) as f:
            assert f.read().strip() == text
    assert all(os.path.exists(os.path.join(d, "contact_sheet.png")) for d in labeled)
    assert any("episode_0" in s for s in shown)
    labeled2 = LT.run_labeler(capture_root, input_fn=lambda _: pytest.fail("prompted"),
                              print_fn=lambda s: None)
    assert labeled2 == {}


def test_labeler_reuse_skip_quit_and_previews_equal_jax(capture_root):
    from vla_touch_tpu.data import label_tool as JLT
    from vla_touch_tpu_torch.data import label_tool as LT

    answers = iter(["grasp the cup", "q"])
    labeled = LT.run_labeler(capture_root, input_fn=lambda _: next(answers),
                             print_fn=lambda s: None)
    assert len(labeled) == 1
    answers = iter(["-", "0", "=", "wipe gently"])
    shown = []
    labeled = LT.run_labeler(capture_root, relabel=True, input_fn=lambda _: next(answers),
                             print_fn=shown.append)
    assert list(labeled.values()) == ["wipe gently"]
    assert any("no suggestion #0" in s for s in shown)
    assert any("no previous instruction" in s for s in shown)
    d = os.path.join(capture_root, "episode_1")
    sheet = LT.contact_sheet(d)
    np.testing.assert_array_equal(sheet, JLT.contact_sheet(d))
    assert LT._ascii_preview(sheet) == JLT._ascii_preview(sheet)
    assert LT.episode_dirs(capture_root) == JLT.episode_dirs(capture_root)


def test_review_gelsight_matches_jax(capture_root):
    from vla_touch_tpu.data import label_tool as JLT
    from vla_touch_tpu_torch.data import label_tool as LT

    cfg = TM.TrackerConfig(**dataclasses.asdict(JAX_TRACK_CFG))
    d = os.path.join(capture_root, "episode_0")
    out = LT.review_gelsight(d, out_dir=os.path.join(d, "port"), tracker_cfg=cfg,
                             device="cpu")
    ref = JLT.review_gelsight(d, out_dir=os.path.join(d, "jax"), tracker_cfg=JAX_TRACK_CFG)
    assert out["frames"] == ref["frames"] == 3
    od = out["out_dir"]
    assert os.path.exists(os.path.join(od, "index.html"))
    assert os.path.exists(os.path.join(od, "marker_000002.png"))
    csv = open(os.path.join(od, "forces.csv")).read().splitlines()
    ref_csv = open(os.path.join(ref["out_dir"], "forces.csv")).read().splitlines()
    assert csv[0] == ref_csv[0] == "frame,fx,fy,mag" and len(csv) == 4
    got = np.array([[float(x) for x in r.split(",")] for r in csv[1:]])
    want = np.array([[float(x) for x in r.split(",")] for r in ref_csv[1:]])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mags = got[:, 3]
    assert mags[2] > mags[1] > mags[0] >= 0.0
    assert out["max_force"] == pytest.approx(mags[2])


def test_cli_label_entry(capture_root, monkeypatch):
    from vla_touch_tpu_torch.data import label_tool as LT

    monkeypatch.setattr("builtins.input", lambda _="": "press the button")
    LT.main(["label", capture_root])
    with open(os.path.join(capture_root, "episode_0", "instruction.txt")) as f:
        assert "press the button" == f.read().strip()
