"""PyTorch port, the offline tools: the GelSight tracker's HSR path and
batched force sequences, the rotation conversions, file locks, the plots
(and the evaluations' ``visualize_dir``), the hub push and the RDT
trainer's pretrained-weight and push flags, against the JAX package on the
same inputs (CPU, float32).

Tolerances: masks and equalized frames exact; forces 1e-5 abs (the same
float32 arithmetic in another order); rotations 1e-6 abs (numpy's and
XLA's float32 sin / cos / atan2 and XLA's fused multiply-adds differ by an
ulp; the largest difference measured is 2.4e-7).
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.ops import marker_tracking as JM
from vla_touch_tpu.utils import geometry as JG
from vla_touch_tpu_torch.ops import marker_tracking as TM
from vla_touch_tpu_torch.utils import geometry as TG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.array(a))


def marker_frame(shift=(0.0, 0.0), H=140, W=180, rows=7, cols=9, radius=3, bg=200.0,
                 fg=40.0):
    """Dark marker dots on a regular grid, shifted by ``shift`` pixels
    (``tests/test_marker_tracking.py``'s frames)."""
    img = np.full((H, W), bg, np.float32)
    ch, cw = H // rows, W // cols
    yy, xx = np.mgrid[0:H, 0:W]
    for r in range(rows):
        for c in range(cols):
            d2 = (yy - (r * ch + ch / 2 + shift[1])) ** 2 + (xx - (c * cw + cw / 2 + shift[0])) ** 2
            img[d2 <= radius ** 2] = fg
    return img


def hsr_frame(shift=(0.0, 0.0), gain=1.0):
    """An HSR-lighting frame: dark markers on a midtone field, at a global
    exposure ``gain``."""
    return np.clip(marker_frame(shift, bg=120.0, fg=30.0) * gain, 0, 255)


# ---- the tracker ---------------------------------------------------------------------


def test_tracker_config_equals_jax_field_for_field():
    jf, tf = dataclasses.fields(JM.TrackerConfig), dataclasses.fields(TM.TrackerConfig)
    assert [(f.name, f.default) for f in tf] == [(f.name, f.default) for f in jf]


@pytest.mark.parametrize("kind", ["random", "narrow", "constant", "float"])
def test_equalize_hist_equals_jax(rng, kind):
    frames = {"random": rng.integers(0, 256, (48, 64)),
              "narrow": rng.integers(20, 200, (48, 64)),
              "constant": np.full((48, 64), 7),
              "float": rng.uniform(-5, 260, (48, 64))}
    img = frames[kind].astype(np.float32)
    got = TM.equalize_hist(_t(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JM.equalize_hist(jnp.asarray(img))))
    # frames batched: each on its own histogram
    two = np.stack([img, 255.0 - img])
    got2 = TM.equalize_hist(_t(two)).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got2[i], np.asarray(JM.equalize_hist(jnp.asarray(two[i]))))


def test_hsr_mask_and_force_equal_jax():
    jc, tc = JM.TrackerConfig(gelsight_version="hsr"), TM.TrackerConfig(gelsight_version="hsr")
    base, moved = hsr_frame(), hsr_frame((2.0, 1.0), gain=1.15)
    for img in (base, moved, np.stack([moved] * 3, axis=-1)):
        np.testing.assert_array_equal(TM.marker_mask(_t(img), tc).numpy(),
                                      np.asarray(JM.marker_mask(jnp.asarray(img), jc)))
    jb, tb = JM.calibrate(jnp.asarray(base), jc), TM.calibrate(_t(base), tc)
    assert int(tb["valid"].sum()) == 63
    np.testing.assert_array_equal(tb["centroids"].numpy(), np.asarray(jb["centroids"]))
    jf, tf = JM.estimate_force(jnp.asarray(moved), jb, jc), TM.estimate_force(_t(moved), tb, tc)
    np.testing.assert_array_equal(tf["valid"].numpy(), np.asarray(jf["valid"]))
    for key in ("displacement", "mean_disp", "magnitude", "direction", "force"):
        np.testing.assert_allclose(tf[key].numpy(), np.asarray(jf[key]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tf["mean_disp"].numpy(), (2.0, 1.0), atol=0.5)


@pytest.mark.parametrize("version", ["standard", "hsr"])
@pytest.mark.parametrize("rgb", [False, True])
def test_force_sequence_equals_jax_and_per_frame(rng, version, rgb):
    """T = 8 frames along a planted path: the batched pass against JAX's
    vmapped one (forces 1e-5), the masks exactly, and each frame's force
    equal to ``estimate_force`` on that frame bit for bit."""
    jc = JM.TrackerConfig(gelsight_version=version)
    tc = TM.TrackerConfig(gelsight_version=version)
    make = hsr_frame if version == "hsr" else marker_frame
    path = [(0.5 * i, -0.25 * i) for i in range(8)]
    frames = np.stack([make(s) for s in path])
    if version == "standard":                      # sensor noise
        frames = frames + rng.integers(0, 3, frames.shape).astype(np.float32)
    if rgb:
        frames = np.stack([frames] * 3, axis=-1)
    base = frames[0]
    jb, tb = JM.calibrate(jnp.asarray(base), jc), TM.calibrate(_t(base), tc)
    want = JM.estimate_force_sequence(jnp.asarray(frames), jb, jc)
    got = TM.estimate_force_sequence(_t(frames), tb, tc)
    assert got["forces"].shape == (8, 3) and got["displacements"].shape == (8, 2)
    for key in ("forces", "displacements"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["displacements"].numpy(), np.asarray(path), atol=0.5)
    for t in (0, 3, 7):
        np.testing.assert_array_equal(
            TM.marker_mask(_t(frames[t]), tc).numpy(),
            np.asarray(JM.marker_mask(jnp.asarray(frames[t]), jc)))
        one = TM.estimate_force(_t(frames[t]), tb, tc)
        assert torch.equal(one["force"], got["forces"][t])


# ---- geometry --------------------------------------------------------------------------


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


GIMBAL = np.array([[0.3, np.pi / 2, 0.7], [0.1, -np.pi / 2, -0.4], [0.0, 0.0, 0.0],
                   [np.pi, 0.0, 0.0], [0.0, np.pi, 0.0]])


def _geometry_inputs(rng, name):
    q = _quats(rng, 128)
    e = rng.uniform(-np.pi, np.pi, (128, 3))
    flips = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                      np.diag([-1.0, -1, 1])])
    m = np.asarray(JG.quaternion_to_rotation_matrix(q))
    o6 = rng.normal(size=(64, 6))
    return {
        "quaternion_to_rotation_matrix": [q, rng.normal(size=(8, 4))],
        "rotation_matrix_to_quaternion": [m, flips],
        "euler_to_rotation_matrix": [e, GIMBAL],
        "rotation_matrix_to_euler": [m, np.asarray(JG.euler_to_rotation_matrix(GIMBAL)), flips],
        "quaternion_to_euler": [q],
        "euler_to_quaternion": [e, GIMBAL],
        "rotation_matrix_to_ortho6d": [m],
        "ortho6d_to_rotation_matrix": [o6],
        "quaternion_to_ortho6d": [q],
        "ortho6d_to_quaternion": [o6, np.asarray(JG.rotation_matrix_to_ortho6d(flips))],
        "ee_pose_7d_to_9d": [np.concatenate([rng.normal(size=(64, 3)), q[:64]], -1)],
        "ee_pose_9d_to_7d": [np.concatenate([rng.normal(size=(64, 3)), o6], -1)],
        "normalize_vector": [rng.normal(size=(16, 5)), np.zeros((2, 3))],
    }[name]


@pytest.mark.parametrize("name", [
    "quaternion_to_rotation_matrix", "rotation_matrix_to_quaternion",
    "euler_to_rotation_matrix", "rotation_matrix_to_euler", "quaternion_to_euler",
    "euler_to_quaternion", "rotation_matrix_to_ortho6d", "ortho6d_to_rotation_matrix",
    "quaternion_to_ortho6d", "ortho6d_to_quaternion", "ee_pose_7d_to_9d",
    "ee_pose_9d_to_7d", "normalize_vector"])
def test_geometry_equals_jax(rng, name):
    for x in _geometry_inputs(rng, name):
        got = getattr(TG, name)(x)
        want = np.asarray(getattr(JG, name)(jnp.asarray(x, jnp.float32)))
        assert got.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)


def test_geometry_branches_equal_jax_at_gimbal_lock_and_on_pivot_ties():
    """The gimbal-lock test and the quaternion's pivot choice go JAX's way:
    yaw carries the whole rotation at pitch +-pi/2, and a 180-degree
    rotation keeps the first largest pivot."""
    m = JG.euler_to_rotation_matrix(jnp.asarray(GIMBAL[:2], jnp.float32))
    got = TG.rotation_matrix_to_euler(np.asarray(m))
    assert (got[:, 0] == 0).all()
    np.testing.assert_allclose(got, np.asarray(JG.rotation_matrix_to_euler(m)), atol=1e-6)
    flips = np.stack([np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
    np.testing.assert_array_equal(TG.rotation_matrix_to_quaternion(flips),
                                  np.asarray(JG.rotation_matrix_to_quaternion(flips)))


# ---- file locks ---------------------------------------------------------------------

_CHILD = """
import sys
from vla_touch_tpu_torch.utils.filelock import FileLock
with open(sys.argv[1], "a+") as f:
    lock = FileLock(f)
    for kind in sys.argv[2:]:
        try:
            getattr(lock, kind + "_lock")(blocking=False)
            print(kind, "got")
            lock.release()
        except BlockingIOError:
            print(kind, "blocked")
"""


def _child(path, *kinds):
    out = subprocess.run([sys.executable, "-c", _CHILD, path, *kinds], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT)).stdout.split()
    return dict(zip(out[::2], out[1::2]))


def test_filelock_exclusive_and_shared_across_processes(tmp_path):
    from vla_touch_tpu_torch.utils.filelock import FileLock

    path = str(tmp_path / "episode.lock")
    with open(path, "a+") as f:
        lock = FileLock(f)
        with lock:                                   # exclusive
            assert _child(path, "read", "write") == {"read": "blocked", "write": "blocked"}
        assert _child(path, "read", "write") == {"read": "got", "write": "got"}
        lock.read_lock(blocking=False)               # shared
        assert _child(path, "read", "write") == {"read": "got", "write": "blocked"}
        lock.release()


# ---- plots -------------------------------------------------------------------------


def test_plots_render_files_from_arrays_and_tensors(tmp_path, rng):
    from vla_touch_tpu_torch.eval import visualize as V

    T, D = 16, 10
    expert = rng.normal(size=(T, D)).astype(np.float32)
    vla = expert + rng.normal(size=(T, D)).astype(np.float32) * 0.1
    refined = torch.as_tensor(expert + rng.normal(size=(T, D)).astype(np.float32) * 0.05)
    p = V.plot_trajectory_comparison(expert, vla, refined, str(tmp_path / "traj.png"),
                                     dims=[0, 3, 9], dim_names=["x", "ry", "grip"])
    assert os.path.getsize(p) > 1000
    paths = V.plot_samples(expert[None].repeat(3, 0), vla[None].repeat(3, 0),
                           refined[None].repeat(3, 1, 1), str(tmp_path / "b"), max_samples=2)
    assert [os.path.basename(q) for q in paths] == ["trajectory_0.png", "trajectory_1.png"]
    assert all(os.path.getsize(q) > 1000 for q in paths)
    frame = marker_frame()
    base = TM.calibrate(_t(frame))
    res = TM.estimate_force(_t(marker_frame((2.0, 1.0))), base)
    p = V.plot_marker_field(_t(frame), base, res, str(tmp_path / "m" / "field.png"))
    assert os.path.getsize(p) > 1000


def test_plots_raise_without_matplotlib(tmp_path, monkeypatch):
    from vla_touch_tpu_torch.eval import visualize as V

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        V.plot_samples(np.zeros((1, 4, 3)), np.zeros((1, 4, 3)), np.zeros((1, 4, 3)),
                       str(tmp_path))


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    from vla_touch_tpu.data.episode import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("episodes"))
    make_synthetic_dataset(root, n_episodes=4, num_steps=30, img_size=28, chunk=8,
                           lang_len=2, lang_dim=8, resized_size=28)
    return root


def test_evaluations_write_plots_to_visualize_dir(tmp_path, episodes, monkeypatch):
    """``bridge_test`` and ``lstm_step_test`` with ``visualize_dir`` write
    the first samples' trajectory PNGs, as JAX's evaluations do."""
    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule
    from vla_touch_tpu_torch.eval import bridge_test as TBE
    from vla_touch_tpu_torch.eval import lstm_step_test as TLE
    from vla_touch_tpu_torch.models.controllers import bridge as TB
    from vla_touch_tpu_torch.models.controllers import lstm as TL
    from vla_touch_tpu_torch.models.encoders import dinov2_runtime as TD
    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig

    monkeypatch.setitem(TD._CONFIGS, "dinov2-small", ViTConfig(
        hidden_size=384, num_layers=1, num_heads=6, mlp_dim=64, image_size=28, patch_size=14))
    H = 8
    dm = ControllerDataModule(episodes, horizon=H, val_ratio=0.25)
    st = TB.init_bridge_controller(TC.BridgeControllerConfig(hidden_dim=32, horizon=H,
                                                             unet_down_dims=(16, 32)),
                                   device="cpu")
    st.stats = dm.stats
    res = TBE.test_diffusion_controller("", episodes, num_samples=6, state=st, data_module=dm,
                                        visualize_dir=str(tmp_path / "bridge"), device="cpu")
    assert np.isfinite(res["action_mse"])
    assert sorted(os.listdir(tmp_path / "bridge")) == [f"trajectory_{i}.png" for i in range(4)]
    lst = TL.init_lstm_controller(TC.LSTMControllerConfig(hidden_dim=32), device="cpu")
    lst.stats = dm.stats
    res = TLE.test_lstm_controller("", episodes, num_samples=3, horizon=H, state=lst,
                                   visualize_dir=str(tmp_path / "lstm"), device="cpu")
    assert np.isfinite(res["improvement_pct"])
    assert sorted(os.listdir(tmp_path / "lstm")) == [f"trajectory_{i}.png" for i in range(3)]


# ---- hub --------------------------------------------------------------------------


class _Repo:
    def __init__(self, repo_id):
        self.repo_id = repo_id


def _fake_hh(record):
    m = types.ModuleType("huggingface_hub")

    def create_repo(repo_id, exist_ok=False, token=None):
        record.append(("create_repo", repo_id, exist_ok, token))
        return _Repo("user/" + repo_id)

    def upload_folder(**kw):
        record.append(("upload_folder", kw))

    m.create_repo, m.upload_folder = create_repo, upload_folder
    return m


def test_push_checkpoint_to_hub_calls_as_jax(tmp_path, monkeypatch):
    """The port's push makes the calls JAX's makes (``tests/test_hub.py``'s
    fake module), and its card differs from JAX's only in naming PyTorch
    and the port's formats."""
    from vla_touch_tpu.utils import hub as JH
    from vla_touch_tpu_torch.utils import hub as TH

    calls = {}
    for name, mod in (("jax", JH), ("port", TH)):
        record = []
        monkeypatch.setitem(sys.modules, "huggingface_hub", _fake_hh(record))
        out = tmp_path / name / "rdt-finetune"
        (out / "checkpoint-100").mkdir(parents=True)
        assert mod.push_checkpoint_to_hub(str(out), token="tok", base_model="rdt-1b") \
            == "user/rdt-finetune"
        kw = dict(record[1][1], folder_path=os.path.basename(record[1][1]["folder_path"]))
        calls[name] = [record[0], kw]
        card = (out / "README.md").read_text()
        assert "user/rdt-finetune" in card and "rdt-1b" in card
    assert calls["port"] == calls["jax"]
    assert TH.DEFAULT_ALLOW_PATTERNS == JH.DEFAULT_ALLOW_PATTERNS
    card = open(TH.save_model_card("user/rdt", None, str(tmp_path))).read()
    assert "(from scratch)" in card and "pytorch" in card and "jax" not in card
    record = []
    monkeypatch.setitem(sys.modules, "huggingface_hub", _fake_hh(record))
    assert TH.push_checkpoint_to_hub(str(tmp_path), hub_model_id="org/x") == "user/org/x"
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        TH.push_checkpoint_to_hub(str(tmp_path))


# ---- the RDT trainer's pretrained weights and push --------------------------------------


def _tiny_siglip_hf(seed=0):
    """An HF ``SiglipVisionModel`` state dict at the tiny scale's tower
    (48 wide, one layer, 28^2 at patch 14)."""
    from vla_touch_tpu_torch.train.rdt_loop import TINY_VIT as c

    r = np.random.default_rng(seed)
    D, F, p = c.hidden_size, c.mlp_dim, c.patch_size
    shapes = {"embeddings.patch_embedding.weight": (D, 3, p, p),
              "embeddings.patch_embedding.bias": (D,),
              "embeddings.position_embedding.weight": ((c.image_size // p) ** 2, D),
              "post_layernorm.weight": (D,), "post_layernorm.bias": (D,)}
    for i in range(c.num_layers):
        pre = f"encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            shapes[pre + n + ".weight"] = shapes[pre + n + ".bias"] = (D,)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[pre + f"self_attn.{n}.weight"] = (D, D)
            shapes[pre + f"self_attn.{n}.bias"] = (D,)
        shapes[pre + "mlp.fc1.weight"], shapes[pre + "mlp.fc1.bias"] = (F, D), (F,)
        shapes[pre + "mlp.fc2.weight"], shapes[pre + "mlp.fc2.bias"] = (D, F), (D,)
    return {f"vision_model.{k}": r.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.fixture
def spy_train(monkeypatch):
    """``RDTTrainer.train`` replaced by a recorder of what the CLI hands it."""
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    seen = {}

    def train(self, **kw):
        seen.update(kw, trainer=self)
        return "state"

    monkeypatch.setattr(TRL.RDTTrainer, "train", train)
    return seen


def test_cli_pretrained_rdt_loads_the_file_bit_for_bit_as_jax(tmp_path, spy_train):
    from vla_touch_tpu.utils import torch_port as JTP
    from vla_touch_tpu_torch.config import rdt_tiny
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.train import rdt_loop as TRL
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils import torch_port as TTP

    rcfg = R.RDTRunnerConfig(model=rdt_tiny())
    src = R.init_rdt(rcfg, seed=5, device="cpu")
    with torch.no_grad():
        for p in src.parameters():                 # no zero-initialised leaf
            p.add_(0.01)
    path = TTP.save_rdt_checkpoint(str(tmp_path / "model.safetensors"), src)
    TRL.main(["--model_scale", "tiny", "--pretrained_model_name_or_path", path,
              "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    module = spy_train["init_module"]
    assert spy_train["vision"] is None
    assert module.model.final_ffn.fc2.weight.requires_grad
    got = {k: v.detach() for k, v in module.state_dict().items()}
    want = src.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k].float()), k
    jtree = JTP.load_rdt_checkpoint(path, depth=rcfg.model.depth)
    for k, v in FF.rdt_runner(jax.tree.map(np.asarray, jtree)).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_cli_siglip_checkpoint_loads_safetensors_and_torch_files(tmp_path, spy_train, fmt):
    from vla_touch_tpu_torch.train import rdt_loop as TRL
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils import safetensors_io as ST
    from vla_touch_tpu_torch.utils import torch_port as TTP

    sd = _tiny_siglip_hf()
    path = str(tmp_path / f"siglip.{fmt}")
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == "safetensors":
        ST.save_file(tensors, path)
    else:
        torch.save(tensors, path)
    TRL.main(["--model_scale", "tiny", "--siglip_checkpoint", path,
              "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    vision = spy_train["vision"]
    assert spy_train["init_module"] is None
    want = FF.vit(TTP.siglip_from_hf(sd, num_layers=TRL.TINY_VIT.num_layers))
    got = vision.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(got["vit.blocks.0.attention.query.weight"].numpy(),
                                  sd["vision_model.encoder.layers.0.self_attn.q_proj.weight"])


def test_cli_push_to_hub_uploads_after_training(tmp_path, spy_train, monkeypatch):
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    record = []
    monkeypatch.setitem(sys.modules, "huggingface_hub", _fake_hh(record))
    out = str(tmp_path / "rdt-run")
    assert TRL.main(["--model_scale", "tiny", "--output_dir", out, "--push_to_hub",
                     "--hub_model_id", "org/rdt", "--hub_token", "tok",
                     "--device", "cpu"]) == "state"
    assert record[0] == ("create_repo", "org/rdt", True, "tok")
    kind, kw = record[1]
    assert kind == "upload_folder" and kw["folder_path"] == out
    assert kw["repo_id"] == "user/org/rdt" and kw["token"] == "tok"
    assert os.path.exists(os.path.join(out, "README.md"))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        TRL.main(["--model_scale", "tiny", "--output_dir", out, "--push_to_hub",
                  "--device", "cpu"])
