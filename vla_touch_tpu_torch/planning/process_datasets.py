"""Raw tactile-dataset processing (counterpart of
``vla_touch_tpu/planning/process_datasets.py``): walk the three raw tactile
corpora (PhysiCLeAR, the hardness corpus, ObjectFolder-real), extract each
recording into ``{out}/{dataset}_{i}/tactile/`` with a ``data.json``
(object id and display name, human ratings, split), reduce recordings to
their salient span, and build the ``{split}_samples.json`` registries
(object id -> sample dirs) that the QA generators (:mod:`planning.qa`) and
the datasets read.

A recording is a directory of frames (copied) or a video file (decoded
through OpenCV, imported when a video is met).  Frames are read with
Pillow (``planning/datasets.py``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from vla_touch_tpu_torch.planning import physiclear as PC
from vla_touch_tpu_torch.planning.datasets import _read_frame
from vla_touch_tpu_torch.planning.frames import extract_salient_frames


def _data_json(path: str, payload: dict) -> None:
    with open(os.path.join(path, "data.json"), "w") as f:
        json.dump(payload, f, indent=4)


def extract_recording(src: str, sample_dir: str,
                      max_frames: Optional[int] = None) -> int:
    """One recording (video file or frame dir) -> ``sample_dir/tactile/``.
    Returns the number of frames written."""
    tdir = os.path.join(sample_dir, "tactile")
    os.makedirs(tdir, exist_ok=True)
    if os.path.isdir(src):
        names = sorted(n for n in os.listdir(src)
                       if n.lower().endswith((".jpg", ".jpeg", ".png")))
        if max_frames:
            names = names[:max_frames]
        for i, n in enumerate(names):
            shutil.copyfile(os.path.join(src, n),
                            os.path.join(tdir, f"frame_{i:06d}.jpg"))
        return len(names)
    import cv2

    cap = cv2.VideoCapture(src)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and i >= max_frames):
            break
        cv2.imwrite(os.path.join(tdir, f"frame_{i:06d}.jpg"), frame)
        i += 1
    cap.release()
    return i


def _physiclear_object_id(file_name: str) -> str:
    """``{object}_{recording}.mp4`` -> ``physiclear_{object}``
    (``process_datasets.py:37-39`` filename convention)."""
    stem = os.path.splitext(file_name)[0]
    return "physiclear_" + "_".join(stem.split("_")[:-1]).strip()


def extract_physiclear(tactile_root: str, out_dir: str,
                       dataset: str = "physiclear") -> int:
    """PhysiCLeAR layout: ``{root}/{exploratory_procedure}/{object}_{k}``.
    Samples with ids missing from the property tables are skipped (the
    reference's KeyError-continue)."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    ratings = PC.RATINGS
    for ep in sorted(os.listdir(tactile_root)):
        ep_path = os.path.join(tactile_root, ep)
        if not os.path.isdir(ep_path):
            continue
        for name in sorted(os.listdir(ep_path)):
            object_id = _physiclear_object_id(name)
            if object_id not in ratings["hardness"]:
                continue
            if object_id in PC.TRAIN_OBJECTS:
                split = "train"
            elif object_id in PC.VAL_OBJECTS:
                split = "val"
            elif object_id in PC.TEST_OBJECTS:
                split = "test"
            else:
                continue
            sdir = os.path.join(out_dir, f"{dataset}_{count}")
            n = extract_recording(os.path.join(ep_path, name), sdir)
            if n == 0:
                continue
            _data_json(sdir, {
                "object_id": object_id,
                "object": PC.OBJECTS_PART_NAMES[object_id],
                "properties": {
                    "hardness": ratings["hardness"][object_id],
                    "roughness": ratings["roughness"][object_id],
                },
                "tactile_format": "video",
                "exploratory_procedure": ep,
                "tactile_path": os.path.join(ep_path, name),
                "split": split,
            })
            count += 1
    return count


def extract_hardness(tactile_root: str, out_dir: str,
                     dataset: str = "hardness") -> int:
    """Hardness-corpus layout: ``{root}/{collection}/{a}_{b}_*``; object id
    = first two filename tokens; all samples are train-split and unrated."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for coll in sorted(os.listdir(tactile_root)):
        cpath = os.path.join(tactile_root, coll)
        if not os.path.isdir(cpath):
            continue
        for name in sorted(os.listdir(cpath)):
            stem = os.path.splitext(name)[0]
            object_id = f"{dataset}_" + "_".join(stem.split("_")[:2]).strip()
            sdir = os.path.join(out_dir, f"{dataset}_{count}")
            n = extract_recording(os.path.join(cpath, name), sdir)
            if n == 0:
                continue
            _data_json(sdir, {
                "object_id": object_id,
                "tactile_format": "video",
                "tactile_path": os.path.join(cpath, name),
                "split": "train",
            })
            count += 1
    return count


def objectfolder_names() -> dict:
    """Numeric object id -> display name (100 entries, vendored data)."""
    return {int(k): v for k, v in PC._data()["objectfolder_names"].items()}


def extract_objectfolder(dataset_root: str, out_dir: str,
                         dataset: str = "objectfolder") -> int:
    """ObjectFolder-real layout:
    ``{root}/{id}/tactile_data/{sample}/0/gelsight/*``."""
    os.makedirs(out_dir, exist_ok=True)
    names = objectfolder_names()
    count = 0
    for object_id in sorted(os.listdir(dataset_root)):
        opath = os.path.join(dataset_root, object_id, "tactile_data")
        if not os.path.isdir(opath) or not object_id.isdigit():
            continue
        for sample in sorted(os.listdir(opath)):
            gel = os.path.join(opath, sample, "0", "gelsight")
            # backup check on the SAMPLE name only — a dataset root that
            # happens to contain "backup" must not skip everything
            if "backup" in sample or not os.path.isdir(gel):
                continue
            sdir = os.path.join(out_dir, f"{dataset}_{count}")
            n = extract_recording(gel, sdir)
            if n == 0:
                continue
            _data_json(sdir, {
                "object_id": f"objectfolder_{object_id}",
                "object": names.get(int(object_id), f"object {object_id}"),
                "tactile_format": "video",
                "exploratory_procedure": "pressing",
                "tactile_path": gel,
                "split": "train",
            })
            count += 1
    return count


def reduce_to_salient_spans(out_dir: str, threshold: float = 2.0,
                            top_k: int = 5) -> int:
    """Per-sample salient-frame reduction over the extracted ``tactile/``
    dirs: keeps only the top-k frames of each sample's salient span
    (:func:`planning.frames.extract_salient_frames`)."""
    reduced = 0
    for name in sorted(os.listdir(out_dir)):
        tdir = os.path.join(out_dir, name, "tactile")
        if not os.path.isdir(tdir):
            continue
        files = sorted(os.listdir(tdir))
        if len(files) <= top_k:
            continue
        # BGR, as OpenCV reads the frames
        frames = np.stack([_read_frame(os.path.join(tdir, f))[:, :, ::-1] for f in files])
        idx = extract_salient_frames(frames, threshold=threshold,
                                     top_k=top_k)
        keep = {files[i] for i in idx}
        for f in files:
            if f not in keep:
                os.remove(os.path.join(tdir, f))
        reduced += 1
    return reduced


def build_samples_json(out_dir: str, train_json_path: str,
                       val_json_path: str, test_json_path: str,
                       holdout_frac: float = 0.2, seed: int = 0) -> dict:
    """Sample registries {object_id: [sample_dir, ...]} per split
    (``get_physiclear_samples`` semantics): objects named in the PhysiCLeAR
    split tables follow them; unrated objects (hardness/objectfolder
    corpora) fall to a random PER-OBJECT train/val holdout (never splitting
    one object's recordings across splits)."""
    rng = np.random.default_rng(seed)
    train, val, test = {}, {}, {}
    tabled = (set(PC.TRAIN_OBJECTS) | set(PC.VAL_OBJECTS)
              | set(PC.TEST_OBJECTS))
    holdout_cache: dict = {}
    for name in sorted(os.listdir(out_dir)):
        sdir = os.path.join(out_dir, name)
        dj = os.path.join(sdir, "data.json")
        if not os.path.exists(dj) or \
                not os.path.isdir(os.path.join(sdir, "tactile")):
            continue
        data = json.load(open(dj))
        obj = data.get("object_id")
        if obj is None:
            continue
        if obj in tabled:
            dest = (test if obj in PC.TEST_OBJECTS else
                    val if obj in PC.VAL_OBJECTS else train)
        else:
            if obj not in holdout_cache:
                holdout_cache[obj] = rng.random() < holdout_frac
            dest = val if holdout_cache[obj] else train
        dest.setdefault(obj, []).append(sdir)
    for path, d in ((train_json_path, train), (val_json_path, val),
                    (test_json_path, test)):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(d, f, indent=2)
    return {"train": train, "val": val, "test": test}
