"""The native episode cache: packer and ctypes bindings (counterpart of
``vla_touch_tpu/runtime/native_loader.py``, the same ``.epc`` files).

The C++ side (``native/episode_cache.cpp``, the port's own copy) mmaps a
packed episode and serves numeric windows and camera frames without the
GIL: raw frames as a memcpy, JPEG frames decoded by libjpeg on its threads
where the build found ``jpeglib.h``.  On the card JPEG frames decode with
nvJPEG (``csrc/jpeg_decode.cu``) from the blobs the cache points at.  A
build without libjpeg refuses a host JPEG decode: it never decodes through
another host codec.

:func:`pack_episode` converts an episode (h5 where ``h5py`` is installed,
or the port's npz layout) into a ``.epc`` file once, JPEG-encoding the
camera frames with OpenCV (the JPEG round trip the deployment loop applies
anyway) or storing them raw.

The library is built on first use (``g++ -O2 -std=c++17 -shared -fPIC``,
``-ljpeg`` where the header exists) into ``build/native/<hash>.so`` beside
the package (``.gitignore`` lists ``build/``), under a file lock and an
atomic rename, since several processes may build at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.utils.device import resolve_device

SRC = Path(__file__).resolve().parent / "native" / "episode_cache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
EC_NO_LIBJPEG = 4                  # ec_decode_frames: a JPEG cache, no libjpeg in the build

_MAGIC = b"EPC2"
_SIDE = threading.local()           # host_frames' CUDA stream, one per thread


@functools.cache
def has_libjpeg() -> bool:
    """Whether the host compiler finds ``jpeglib.h``."""
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    return probe.returncode == 0


def build_library(force: bool = False, libjpeg: Optional[bool] = None, build_dir=None) -> str:
    """Compile the shared library into ``build_dir`` (default
    ``build/native``) as ``episode_cache.<hash>.so``, the hash over the
    source and the flags; returns its path.  An existing build is reused
    unless ``force``.  ``libjpeg`` (default: where the header is found)
    defines ``EC_HAVE_LIBJPEG`` and links ``-ljpeg``."""
    from vla_touch_tpu_torch.utils.filelock import FileLock

    libjpeg = has_libjpeg() if libjpeg is None else libjpeg
    flags = CXX_FLAGS + (("-DEC_HAVE_LIBJPEG",) if libjpeg else ())
    libs = (("-ljpeg",) if libjpeg else ()) + ("-lpthread",)
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(flags + libs).encode()).hexdigest()[:16]
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"episode_cache.{digest}.so"
    if path.exists() and not force:
        return str(path)
    with open(out_dir / ".lock", "a+") as lock_file, FileLock(lock_file):
        if path.exists() and not force:          # another process built it
            return str(path)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run(["g++", *flags, str(SRC), "-o", str(tmp), *libs],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"building {SRC.name} failed:\n{run.stderr}")
        os.replace(tmp, path)
    return str(path)


def load_library(path: str) -> ctypes.CDLL:
    """The library at ``path`` with its C entries declared."""
    lib = ctypes.CDLL(path)
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.ec_open.restype = vp
    lib.ec_open.argtypes = [ctypes.c_char_p]
    lib.ec_close.argtypes = [vp]
    lib.ec_info.argtypes = [vp, vp]
    lib.ec_read_window.argtypes = [vp, u32, u32, vp, vp, vp, ctypes.c_int64, vp]
    lib.ec_decode_frames.argtypes = [vp, u32, u32, u32, vp, ctypes.c_int]
    lib.ec_frame_blobs.argtypes = [vp, u32, u32, u32, vp, vp]
    lib.ec_read_lang.argtypes = [vp, vp]
    lib.ec_read_raw_pose.argtypes = [vp, vp, vp]
    lib.ec_have_libjpeg.argtypes = []
    return lib


@functools.cache
def _default_library() -> ctypes.CDLL:
    return load_library(build_library())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_episode(h5_path: str, out_path: str, jpeg_quality: int = 90,
                 use_resized: bool = False, codec: str = "jpeg") -> str:
    """An episode (h5 or npz, read through ``data/episode.py::EpisodeFile``)
    -> ``.epc`` cache (v2): the cameras ``camera1``/``camera2``, or with
    ``use_resized`` the distillation pass's ``camera{N}_resized``.

    ``codec='jpeg'`` re-encodes frames with OpenCV at ``jpeg_quality``
    (small files; the deployment loop's JPEG round trip baked in);
    ``codec='raw'`` stores them losslessly, so training from the cache
    draws the same samples as from the source file.  v2 also packs the
    precomputed T5 embedding and the raw float64 poses and gripper (qpos is
    derived from them in float64, as from the source)."""
    import cv2

    from vla_touch_tpu_torch.data.episode import EpisodeFile, qpos_from_episode

    if codec not in ("jpeg", "raw"):
        raise ValueError(f"codec {codec!r} not in ('jpeg', 'raw')")
    with EpisodeFile(h5_path) as f:
        qpos = qpos_from_episode(f).astype(np.float32)
        T = qpos.shape[0]
        forces = np.asarray(f["gelsight_force/forces"], np.float32)
        disps = np.asarray(f["gelsight_force/displacement"], np.float32)
        has_vla = "vla_action" in f
        vla = (np.asarray(f["vla_action"], np.float32) if has_vla
               else np.zeros((0,), np.float32))
        chunk = int(vla.shape[1]) if has_vla else 0
        has_raw_pose = "ee_poses" in f and "gripper_pos" in f
        if has_raw_pose:
            ee = np.asarray(f["ee_poses"], np.float64)[:, :7]
            grip = np.asarray(f["gripper_pos"], np.float64).reshape(-1)
        lang = (np.asarray(f["instruct_embeddings"], np.float32)
                if "instruct_embeddings" in f else None)
        if lang is not None and lang.ndim == 3:
            lang = lang[0]
        cam_keys = (["camera1_resized", "camera2_resized"] if use_resized
                    else ["camera1/camera1", "camera2/camera2"])
        cams = [np.asarray(f[k]) for k in cam_keys]

    H, W = cams[0].shape[1:3]
    blobs: list = []
    offsets = np.zeros((len(cams), T + 1), np.uint64)
    total = 0
    for ci, frames in enumerate(cams):
        for t in range(T):
            if codec == "raw":
                blobs.append(np.ascontiguousarray(frames[t], dtype=np.uint8).tobytes())
            else:
                ok, enc = cv2.imencode(".jpg", frames[t][:, :, ::-1],   # RGB -> BGR
                                       [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
                if not ok:
                    raise RuntimeError(f"{path}: JPEG encode of camera {ci} frame {t} failed")
                blobs.append(enc.tobytes())
            offsets[ci, t] = total                # absolute within the blob stream
            total += len(blobs[-1])
        offsets[ci, T] = total

    hdr = np.zeros(13, np.uint32)
    hdr[:] = [T, len(cams), H, W, qpos.shape[1], forces.shape[1],
              disps.shape[1], chunk, int(has_vla),
              0 if lang is None else lang.shape[0],
              0 if lang is None else lang.shape[1],
              1 if codec == "raw" else 0, int(has_raw_pose)]
    with open(out_path, "wb") as out:
        out.write(_MAGIC)
        out.write(hdr.tobytes())
        out.write(qpos.tobytes())
        out.write(forces.tobytes())
        out.write(disps.tobytes())
        if has_vla:
            out.write(vla.tobytes())
        if has_raw_pose:
            out.write(np.ascontiguousarray(ee).tobytes())
            out.write(np.ascontiguousarray(grip).tobytes())
        if lang is not None:
            out.write(np.ascontiguousarray(lang).tobytes())
        out.write(offsets.tobytes())
        for b in blobs:
            out.write(b)
    return out_path


def nvjpeg_decode(ptrs: np.ndarray, lens: np.ndarray, H: int, W: int,
                  device=None) -> torch.Tensor:
    """JPEG blobs (host addresses ``ptrs`` and byte lengths ``lens``, uint64)
    decoded by nvJPEG on the card into (count, H, W, 3) uint8 RGB, on the
    current stream (ready when this returns)."""
    from vla_touch_tpu_torch.csrc import build

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"nvjpeg_decode runs on a CUDA device, not {dev}")
    lib, fn = build.entry("jpeg_decode", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p], "vtt_jpeg_decode")
    n = int(len(ptrs))
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
    if n:
        ptrs = np.ascontiguousarray(ptrs, np.uint64)
        lens = np.ascontiguousarray(lens, np.uint64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib, fn(_ptr(ptrs), _ptr(lens), n, out.data_ptr(), H, W, stream),
                        "nvJPEG decode")
    return out


class EpisodeCache:
    """ctypes handle over one ``.epc`` file.  ``library``: a loaded
    library (:func:`load_library`), default the one :func:`build_library`
    builds."""

    def __init__(self, path: str, library: Optional[ctypes.CDLL] = None):
        self._lib = library if library is not None else _default_library()
        self._h = self._lib.ec_open(path.encode())
        if not self._h:
            raise IOError(f"failed to open episode cache: {path}")
        self.path = path
        info = np.zeros(13, np.uint32)
        self._lib.ec_info(self._h, _ptr(info))
        (self.T, self.n_cams, self.H, self.W, self.state_dim,
         self.force_dim, self.disp_dim, self.chunk, self.has_vla,
         self.lang_len, self.lang_dim, self.codec, self.has_raw_pose) = (
            int(x) for x in info)
        self.host_decode = bool(self._lib.ec_have_libjpeg())

    def close(self):
        if self._h:
            self._lib.ec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def read_window(self, start: int, count: int,
                    vla_at: Optional[int] = None) -> dict:
        qpos = np.empty((count, self.state_dim), np.float32)
        forces = np.empty((count, self.force_dim), np.float32)
        disps = np.empty((count, self.disp_dim), np.float32)
        vla = (np.empty((self.chunk, self.state_dim), np.float32)
               if (vla_at is not None and self.has_vla) else None)
        rc = self._lib.ec_read_window(
            self._h, start, count, _ptr(qpos), _ptr(forces), _ptr(disps),
            -1 if vla is None else int(vla_at), None if vla is None else _ptr(vla))
        if rc:
            raise IOError(f"ec_read_window failed rc={rc}")
        out = {"qpos": qpos, "forces": forces, "disps": disps}
        if vla is not None:
            out["vla"] = vla
        return out

    def frame_blobs(self, cam: int, start: int, count: int):
        """(addresses, byte lengths), uint64, of the blobs of frames
        [start, start + count) of camera ``cam``, inside the mmap (valid
        until :meth:`close`)."""
        ptrs = np.zeros(count, np.uint64)
        lens = np.zeros(count, np.uint64)
        rc = self._lib.ec_frame_blobs(self._h, cam, start, count, _ptr(ptrs), _ptr(lens))
        if rc:
            raise IOError(f"ec_frame_blobs failed rc={rc}")
        return ptrs, lens

    def decode_frames(self, cam: int, start: int, count: int, n_threads: int = 4,
                      device=None):
        """Frames [start, start + count) of camera ``cam``, (count, H, W, 3)
        uint8 RGB.  ``device`` (default ``'cuda'`` where a card is present,
        else ``'cpu'``): ``'cpu'`` decodes on ``n_threads`` C++ threads into
        a numpy array; a CUDA device returns a tensor there, JPEG frames
        decoded by nvJPEG, raw frames copied up."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = resolve_device(device)
        if dev.type == "cuda":
            if self.codec == 1:
                return torch.from_numpy(self.decode_frames(cam, start, count, n_threads,
                                                           "cpu")).to(dev)
            ptrs, lens = self.frame_blobs(cam, start, count)
            return nvjpeg_decode(ptrs, lens, self.H, self.W, dev)
        out = np.empty((count, self.H, self.W, 3), np.uint8)
        rc = self._lib.ec_decode_frames(self._h, cam, start, count, _ptr(out), n_threads)
        if rc == EC_NO_LIBJPEG:
            raise RuntimeError(
                f"{self.path}: this build of the episode cache has no libjpeg, so JPEG "
                "frames do not decode on the host; decode them with device='cuda' (nvJPEG)")
        if rc:
            raise IOError(f"ec_decode_frames failed rc={rc}")
        return out

    def host_frames(self, cam: int, start: int, count: int, n_threads: int = 4) -> np.ndarray:
        """Frames for numpy consumers: decoded on the host where this build
        can (raw frames always), else by nvJPEG on the card and copied back
        once, on a stream of the calling thread's own, so that a loader
        thread's decode waits for no work of the training stream."""
        if self.codec == 1 or self.host_decode:
            return self.decode_frames(cam, start, count, n_threads, "cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(f"{self.path}: JPEG frames need libjpeg in the build or a CUDA "
                               "device (nvJPEG); this machine has neither")
        dev = torch.device("cuda", torch.cuda.current_device())
        side = getattr(_SIDE, "stream", None)
        if side is None or side.device != dev:
            side = _SIDE.stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            return self.decode_frames(cam, start, count, device=dev).cpu().numpy()

    def read_lang(self) -> Optional[np.ndarray]:
        """Precomputed T5 embedding (lang_len, lang_dim) float32, or None."""
        if not self.lang_len:
            return None
        out = np.empty((self.lang_len, self.lang_dim), np.float32)
        rc = self._lib.ec_read_lang(self._h, _ptr(out))
        if rc:
            raise IOError(f"ec_read_lang failed rc={rc}")
        return out

    def read_raw_pose(self):
        """(ee_poses (T, 7) float64, gripper (T,) float64), or None if not
        packed."""
        if not self.has_raw_pose:
            return None
        ee = np.empty((self.T, 7), np.float64)
        grip = np.empty((self.T,), np.float64)
        rc = self._lib.ec_read_raw_pose(self._h, _ptr(ee), _ptr(grip))
        if rc:
            raise IOError(f"ec_read_raw_pose failed rc={rc}")
        return ee, grip
