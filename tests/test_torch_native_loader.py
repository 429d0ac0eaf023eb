"""PyTorch port, the native episode cache and the datasets and trainers that
read it, against the JAX package (CPU).

- Packing: the port packs h5 and npz episodes into ``.epc`` files byte for
  byte equal to JAX's ``pack_episode`` on the h5 file (both codecs, both
  camera layouts).
- Reading: the port's ``EpisodeCache`` reads JAX-packed v2 and v1 files
  as JAX's reader does; its host JPEG decode equals JAX's byte for byte
  (both libjpeg); the bounds errors are JAX's.
- The datasets: with ``codec='raw'`` the ``UnifiedVLADataset`` and
  ``ControllerDataset`` samples from ``.epc`` equal those from the source
  files bit for bit; ``batches(workers=3)`` equals ``workers=0``.
- The trainers: a BRIDGeR step and an ``rdt_loop --model_scale tiny`` step
  read ``.epc`` and train as from the source files, bit for bit.
- A build without libjpeg refuses a host JPEG decode (no fallback codec).
- ``data/pipeline.py::OrderedPrefetcher``: task order, bounded in-flight
  work, errors raised where their result would be.
"""

import filecmp
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.data import episode as JE
from vla_touch_tpu.runtime import native_loader as JN
from vla_touch_tpu_torch.data import episode as TE
from vla_touch_tpu_torch.runtime import native_loader as TN

EP = dict(num_steps=30, img_size=32, chunk=8, lang_dim=16, resized_size=24)


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


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """One episode written by both packages (JAX: h5, the port: npz; the
    same arrays for the same seed), packed by JAX from the h5 and by the
    port from both, in both codecs and both camera layouts."""
    root = tmp_path_factory.mktemp("native")
    h5, npz = str(root / "ep.h5"), str(root / "ep.npz")
    JE.write_synthetic_episode(h5, **EP)
    TE.write_synthetic_episode(npz, **EP)
    out = {"h5": h5, "npz": npz, "root": root}
    for codec in ("jpeg", "raw"):
        for resized in (False, True):
            tag = f"{codec}{'_resized' if resized else ''}"
            kw = dict(codec=codec, use_resized=resized)
            out[f"jax_{tag}"] = JN.pack_episode(h5, str(root / f"jax_{tag}.epc"), **kw)
            out[f"h5_{tag}"] = TN.pack_episode(h5, str(root / f"h5_{tag}.epc"), **kw)
            out[f"npz_{tag}"] = TN.pack_episode(npz, str(root / f"npz_{tag}.epc"), **kw)
    return out


@pytest.mark.parametrize("tag", ["jpeg", "raw", "jpeg_resized", "raw_resized"])
def test_packed_files_equal_jax_byte_for_byte(packed, tag):
    for src in ("h5", "npz"):
        assert filecmp.cmp(packed[f"{src}_{tag}"], packed[f"jax_{tag}"], shallow=False), src


def test_header_windows_lang_and_poses_equal_jax(packed):
    got, want = TN.EpisodeCache(packed["jax_jpeg"]), JN.EpisodeCache(packed["jax_jpeg"])
    fields = ("T", "n_cams", "H", "W", "state_dim", "force_dim", "disp_dim", "chunk",
              "has_vla", "lang_len", "lang_dim", "codec", "has_raw_pose")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert (got.T, got.n_cams, got.H, got.W, got.chunk) == (30, 2, 32, 32, 8)
    for start, count, vla_at in ((5, 10, 7), (0, 30, None), (29, 1, 0)):
        a, b = got.read_window(start, count, vla_at), want.read_window(start, count, vla_at)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(got.read_lang(), want.read_lang())
    for a, b in zip(got.read_raw_pose(), want.read_raw_pose()):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    got.close()
    want.close()


def _v1_copy(v2_path: str, out: str) -> str:
    """The v2 file rewritten as a v1 file ('EPC1', 9 header words, no raw
    poses and no language)."""
    c = JN.EpisodeCache(v2_path)
    T, S = c.T, c.state_dim
    raw = open(v2_path, "rb").read()
    p = 4 + 13 * 4
    numeric = T * (S + c.force_dim + c.disp_dim) * 4 + T * c.chunk * S * 4
    head = raw[4:4 + 9 * 4]
    skip = T * 7 * 8 + T * 8 + c.lang_len * c.lang_dim * 4
    c.close()
    with open(out, "wb") as f:
        f.write(b"EPC1" + head + raw[p:p + numeric] + raw[p + numeric + skip:])
    return out


def test_reads_a_v1_file_as_jax(packed):
    v1 = _v1_copy(packed["jax_jpeg"], str(packed["root"] / "v1.epc"))
    got, want = TN.EpisodeCache(v1), JN.EpisodeCache(v1)
    assert (got.lang_len, got.has_raw_pose, got.codec) == (0, 0, 0)
    assert got.read_lang() is None and got.read_raw_pose() is None
    np.testing.assert_array_equal(got.read_window(0, 30, 4)["vla"],
                                  want.read_window(0, 30, 4)["vla"])
    np.testing.assert_array_equal(got.decode_frames(1, 0, 30, device="cpu"),
                                  want.decode_frames(1, 0, 30))
    with TE.EpisodeFile(v1) as f, JE.EpisodeFile(v1) as jf:
        assert "ee_poses" not in f and "qpos" in f
        np.testing.assert_array_equal(TE.qpos_from_episode(f), JE.qpos_from_episode(jf))


def test_host_decode_equals_jax_byte_for_byte(packed):
    got, want = TN.EpisodeCache(packed["jax_jpeg"]), JN.EpisodeCache(packed["jax_jpeg"])
    assert got.host_decode
    for cam in (0, 1):
        for start, count, threads in ((0, 30, 3), (3, 6, 1), (29, 1, 4)):
            a = got.decode_frames(cam, start, count, n_threads=threads, device="cpu")
            assert isinstance(a, np.ndarray) and a.shape == (count, 32, 32, 3)
            np.testing.assert_array_equal(a, want.decode_frames(cam, start, count, threads))
        np.testing.assert_array_equal(got.host_frames(cam, 2, 5), want.decode_frames(cam, 2, 5))
    # raw frames are the source's
    raw = TN.EpisodeCache(packed["jax_raw"])
    with TE.EpisodeFile(packed["npz"]) as f:
        np.testing.assert_array_equal(raw.decode_frames(1, 0, 30, device="cpu"),
                                      np.asarray(f["camera2/camera2"]))


def test_bounds_errors_match_jax(packed):
    got, want = TN.EpisodeCache(packed["jax_jpeg"]), JN.EpisodeCache(packed["jax_jpeg"])
    for call in (lambda c, **kw: c.read_window(25, 10),
                 lambda c, **kw: c.read_window(0, 1, vla_at=30),
                 lambda c, **kw: c.decode_frames(5, 0, 1, **kw),
                 lambda c, **kw: c.decode_frames(0, 28, 3, **kw)):
        with pytest.raises(IOError) as e_want:
            call(want)
        with pytest.raises(IOError) as e_got:
            call(got, device="cpu")
        assert str(e_got.value) == str(e_want.value)
    with pytest.raises(IOError, match="ec_frame_blobs failed rc=2"):
        got.frame_blobs(0, 20, 11)
    for path in (str(packed["root"] / "missing.epc"), packed["h5"]):
        with pytest.raises(IOError, match="failed to open episode cache"):
            TN.EpisodeCache(path)


def test_frame_blobs_point_at_the_packed_jpegs(packed):
    """``frame_blobs`` addresses the packed JPEGs: each decodes (OpenCV,
    libjpeg) to the cache's frame."""
    import ctypes

    import cv2

    c = TN.EpisodeCache(packed["jax_jpeg"])
    ptrs, lens = c.frame_blobs(1, 4, 3)
    frames = c.decode_frames(1, 4, 3, device="cpu")
    for i in range(3):
        blob = np.frombuffer(ctypes.string_at(int(ptrs[i]), int(lens[i])), np.uint8)
        assert blob[:2].tolist() == [0xFF, 0xD8]            # a JPEG's start marker
        np.testing.assert_array_equal(cv2.imdecode(blob, cv2.IMREAD_COLOR)[:, :, ::-1],
                                      frames[i])


def test_cuda_routes_need_a_card(packed, monkeypatch):
    """Without a card the default route is the host's; asking for CUDA
    raises, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = TN.EpisodeCache(packed["jax_jpeg"])
    assert isinstance(c.decode_frames(0, 0, 2), np.ndarray)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        c.decode_frames(0, 0, 2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TN.nvjpeg_decode(*c.frame_blobs(0, 0, 2), 32, 32)


def test_build_without_libjpeg_refuses_a_host_jpeg_decode(packed, tmp_path, monkeypatch):
    path = TN.build_library(libjpeg=False, build_dir=tmp_path)
    assert path != TN.build_library()
    lib = TN.load_library(path)
    assert lib.ec_have_libjpeg() == 0
    c = TN.EpisodeCache(packed["jax_jpeg"], library=lib)
    assert not c.host_decode
    with pytest.raises(RuntimeError, match="no libjpeg.*device='cuda'"):
        c.decode_frames(0, 0, 4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="neither"):
        c.host_frames(0, 0, 4)
    # raw frames need no codec
    raw = TN.EpisodeCache(packed["jax_raw"], library=lib)
    np.testing.assert_array_equal(raw.host_frames(0, 0, 30),
                                  JN.EpisodeCache(packed["jax_raw"]).decode_frames(0, 0, 30))


def test_episode_file_serves_epc_as_jax(packed):
    with TE.EpisodeFile(packed["jax_jpeg"]) as f, JE.EpisodeFile(packed["jax_jpeg"]) as jf, \
            TE.EpisodeFile(packed["npz"]) as src:
        keys = ["qpos", "ee_poses", "gripper_pos", "instruct_embeddings", "vla_action",
                "camera1/camera1", "camera2/camera2", "gelsight_force/forces",
                "gelsight_force/displacement", "camera3/camera3", "camera1_resized"]
        assert [k in f for k in keys] == [k in jf for k in keys]
        assert "ee_poses" in f and "camera1_resized" not in f
        np.testing.assert_array_equal(TE.qpos_from_episode(f), TE.qpos_from_episode(src))
        for k in ("instruct_embeddings", "gelsight_force/forces",
                  "gelsight_force/displacement", "ee_poses", "gripper_pos", "qpos"):
            np.testing.assert_array_equal(np.asarray(f[k]), np.asarray(jf[k]), err_msg=k)
        frames, jframes = f["camera1/camera1"], jf["camera1/camera1"]
        assert frames.shape == jframes.shape == (30, 32, 32, 3)
        np.testing.assert_array_equal(frames[4:7], jframes[4:7])
        np.testing.assert_array_equal(frames[9], jframes[9])
        np.testing.assert_array_equal(np.asarray(frames), np.asarray(jframes))
        with pytest.raises(IndexError):
            frames[0:6:2]
        vla = f["vla_action"]
        assert vla.shape == (30, 8, 10)
        np.testing.assert_array_equal(vla[7], np.asarray(src["vla_action"][7], np.float32))
        np.testing.assert_array_equal(np.asarray(vla), np.asarray(jf["vla_action"]))
        with pytest.raises(KeyError):
            f["camera3/camera3"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Two episodes as JAX's h5 files and the port's npz files, each set
    packed with codec 'raw' (the cameras) and with ``--use_resized`` (the
    controllers' layout)."""
    from vla_touch_tpu_torch.data.pack_epc import pack_dataset

    root = tmp_path_factory.mktemp("datasets")
    out = {}
    for fmt, mk in (("h5", JE.make_synthetic_dataset), ("npz", TE.make_synthetic_dataset)):
        d = str(root / fmt / "mango_hdf5_gelsight")
        mk(d, n_episodes=2, num_steps=40, img_size=40, chunk=8, lang_dim=32,
           resized_size=24)
        out[fmt] = d
        out[f"{fmt}_epc"] = str(root / f"{fmt}_epc" / "mango_hdf5_gelsight")
        pack_dataset(d, out[f"{fmt}_epc"], codec="raw")
        out[f"{fmt}_ctrl"] = str(root / f"{fmt}_ctrl")
        pack_dataset(d, out[f"{fmt}_ctrl"], codec="raw", use_resized=True)
    return out


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_unified_dataset_epc_samples_equal_the_source(datasets, fmt):
    from vla_touch_tpu_torch.config import DataConfig
    from vla_touch_tpu_torch.data.vla_dataset import UnifiedVLADataset

    kw = dict(dataset_names=("mango",), chunk_size=8, image_size=40)
    src = UnifiedVLADataset(DataConfig(data_root=os.path.dirname(datasets[fmt]), **kw), seed=3)
    epc = UnifiedVLADataset(DataConfig(data_root=os.path.dirname(datasets[f"{fmt}_epc"]),
                                       data_format="epc", **kw), seed=3)
    assert len(src) == len(epc) == 2 and all(p.endswith(".epc") for p in epc.file_paths)
    for _ in range(6):
        a, b = src.get_item(), epc.get_item()
        assert a["meta"]["step_id"] == b["meta"]["step_id"]
        for k in ("state", "actions", "state_std", "state_norm", "state_indicator",
                  "cam_high", "cam_right_wrist", "cam_left_wrist", "cam_high_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["meta"]["instruction_embedding"],
                                      b["meta"]["instruction_embedding"])


def test_unified_dataset_epc_equals_jax(datasets):
    """The port's and JAX's samplers on the same ``.epc`` files, same seed."""
    from vla_touch_tpu.config import DataConfig as JDC
    from vla_touch_tpu.data.vla_dataset import UnifiedVLADataset as JDS
    from vla_touch_tpu_torch.config import DataConfig
    from vla_touch_tpu_torch.data.vla_dataset import UnifiedVLADataset

    kw = dict(data_root=os.path.dirname(datasets["h5_epc"]), dataset_names=("mango",),
              chunk_size=8, image_size=40, data_format="epc")
    got, want = UnifiedVLADataset(DataConfig(**kw), seed=5), JDS(JDC(**kw), seed=5)
    for _ in range(4):
        a, b = got.get_item(), want.get_item()
        assert a["meta"]["step_id"] == b["meta"]["step_id"]
        for k in ("actions", "cam_high", "cam_right_wrist"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
        np.testing.assert_allclose(a["state"], b["state"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_controller_dataset_epc_equals_the_source(datasets, fmt):
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataset

    kw = dict(context_frames=2, horizon=8, use_images=True)
    src = ControllerDataset(data_dir=datasets[fmt], **kw)
    epc = ControllerDataset(data_dir=datasets[f"{fmt}_ctrl"], data_format="epc", **kw)
    assert len(src) == len(epc) > 0 and src.episode_indices == epc.episode_indices
    for k in src.stats:
        np.testing.assert_array_equal(src.stats[k], epc.stats[k], err_msg=k)
    for i in (0, len(src) // 2, len(src) - 1):
        a, b = src[i], epc[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_controller_dataset_epc_equals_jax(datasets):
    from vla_touch_tpu.data.controller_dataset import ControllerDataset as JCD
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataset

    kw = dict(context_frames=2, horizon=8, use_images=True, data_format="epc")
    got, want = ControllerDataset(data_dir=datasets["h5_ctrl"], **kw), \
        JCD(data_dir=datasets["h5_ctrl"], **kw)
    assert got.episode_indices == want.episode_indices
    for i in (0, len(got) - 1):
        for k in ("images_cam1", "images_cam2", "vla_actions", "forces"):
            np.testing.assert_array_equal(got[i][k], want[i][k], err_msg=k)


def test_controller_batches_with_workers_equal_serial(datasets):
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataset

    ds = ControllerDataset(data_dir=datasets["npz_ctrl"], data_format="epc", horizon=8)
    serial = list(ds.batches(4, np.random.default_rng(7)))
    pooled = list(ds.batches(4, np.random.default_rng(7), workers=3, prefetch_depth=1))
    assert len(serial) == len(pooled) > 1
    for a, b in zip(serial, pooled):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _module_tensors(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_bridge_train_reads_epc_as_the_source(datasets, tmp_path, monkeypatch):
    """``bridge_train --data_format epc --prefetch_workers 2``: one step
    (one batch of the one training file) on the CPU, the trained weights
    those of the npz run bit for bit; a directory without caches raises.
    The trainer's checkpoints (best and final, 0.8 GB each at the default
    widths) are recorded, not written: nothing here reads them, and the
    controllers' tests hold the checkpoint files."""
    from vla_touch_tpu_torch.train import bridge_train as TBT

    saved = []
    monkeypatch.setattr(TBT.DiffusionControllerTrainer, "_save",
                        lambda self, path: saved.append(os.path.basename(path)))
    argv = ["--horizon", "8", "--batch_size", "16", "--epochs", "1", "--no_visual",
            "--prefetch_workers", "2"]
    runs = {}
    for fmt, extra in (("npz", []), ("npz_ctrl", ["--data_format", "epc"])):
        saved.clear()
        state, trainer = TBT.main(["--data_dir", datasets[fmt], "--output_dir",
                                   str(tmp_path / fmt)] + argv + extra, device="cpu")
        rows = [json.loads(r) for r in open(trainer.metrics.jsonl_path)]
        assert [r["step"] for r in rows if "loss" in r] == [0]
        assert saved[-1] == "final"
        runs[fmt] = (_module_tensors(state.module), rows[0]["loss"])
    (a, la), (b, lb) = runs["npz"], runs["npz_ctrl"]
    assert la == lb and np.isfinite(la)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(FileNotFoundError, match=r"\.epc"):
        TBT.main(["--data_dir", datasets["npz"], "--output_dir", str(tmp_path / "none"),
                  "--data_format", "epc"] + argv, device="cpu")


def test_rdt_loop_reads_epc_as_the_source(datasets, tmp_path):
    """``rdt_loop --data_format epc --model_scale tiny``: one step on the
    CPU, its loss and gradient norm those of the npz run bit for bit."""
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    rows = {}
    for fmt, extra in (("npz", []), ("npz_epc", ["--data_format", "epc"])):
        out = str(tmp_path / fmt)
        TRL.main(["--data_root", os.path.dirname(datasets[fmt]), "--output_dir", out,
                  "--model_scale", "tiny", "--max_train_steps", "1", "--batch_size", "2",
                  "--grad_accum", "1", "--dataloader_num_workers", "1",
                  "--device", "cpu"] + extra)
        rows[fmt] = [(r["step"], r["loss"], r["grad_norm"])
                     for r in map(json.loads, open(os.path.join(out, "training.jsonl")))]
        assert os.path.isdir(os.path.join(out, "checkpoint-1"))
    assert rows["npz"] == rows["npz_epc"] and len(rows["npz"]) == 1
    assert np.isfinite(rows["npz"][0][1])


# ---- data/pipeline.py::OrderedPrefetcher ---------------------------------------------


@pytest.mark.parametrize("workers", [0, 4])
def test_ordered_prefetcher_keeps_task_order(workers):
    from vla_touch_tpu_torch.data.pipeline import OrderedPrefetcher

    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, 24)

    def work(i):
        time.sleep(delays[i])                  # later tasks often finish first
        return i * i

    with OrderedPrefetcher(work, range(24), workers=workers, depth=3) as loader:
        assert list(loader) == [i * i for i in range(24)]
    assert list(OrderedPrefetcher(work, [], workers=2)) == []


def test_ordered_prefetcher_bounds_work_in_flight():
    from vla_touch_tpu_torch.data.pipeline import OrderedPrefetcher

    started, lock = [], threading.Lock()

    def work(i):
        with lock:
            started.append(i)
        return i

    loader = OrderedPrefetcher(work, range(100), workers=2, depth=1)
    first = next(loader)
    time.sleep(0.05)
    with lock:
        n = len(started)
    # the first result plus workers + depth tasks in flight, and no more
    assert first == 0 and n <= 1 + 3
    rest = list(loader)
    assert rest == list(range(1, 100))
    loader.close()


def test_ordered_prefetcher_raises_a_task_error_in_its_place():
    from vla_touch_tpu_torch.data.pipeline import OrderedPrefetcher

    def work(i):
        if i == 3:
            raise ValueError("boom at 3")
        return i

    got = []
    with OrderedPrefetcher(work, range(8), workers=3) as loader:
        with pytest.raises(ValueError, match="boom at 3"):
            for x in loader:
                got.append(x)
    assert got == [0, 1, 2]
