"""Validate pretrained checkpoints against the vendored key manifests
(counterpart of ``vla_touch_tpu/utils/checkpoint_manifest.py``).

The port carries the literal key + shape manifests of the checkpoints its
converters read (``vla_touch_tpu_torch/data/hf_manifests/*.json``, byte
for byte the JAX package's).  Run this validator before converting
downloaded weights with the converter ``KNOWN`` names (a ``utils/torch_port.py``
converter or a planner loader): it names
missing, unexplained and mis-shaped keys of a wrong variant, a truncated
shard or a renamed key instead of failing mid-conversion.

CLI:
    python -m vla_touch_tpu_torch.utils.checkpoint_manifest rdt_1b /path/to/ckpt
    python -m vla_touch_tpu_torch.utils.checkpoint_manifest --list

A checkpoint is a directory of ``*.safetensors`` shards or one such file
(headers only are read, through :mod:`utils.safetensors_io`), or a torch
``.pt`` / ``.bin`` pickle (loaded on the CPU).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Tuple

MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "hf_manifests")

#: manifest name -> the checkpoint it describes + the port's converter
KNOWN = {
    "rdt_1b": ("robotics-diffusion-transformer/rdt-1b",
               "utils.torch_port.rdt_runner"),
    "siglip_so400m": ("google/siglip-so400m-patch14-384 (vision tower)",
                      "utils.torch_port.siglip_from_hf"),
    "dinov2_small": ("facebook/dinov2-small", "utils.torch_port.dinov2_from_hf"),
    "clip_vit_b16_vision": ("openai/clip-vit-base-patch16 (vision)",
                            "utils.torch_port.clip_vision_from_hf"),
    "clip_vit_b16_text": ("openai/clip-vit-base-patch16 (text)",
                          "models.encoders.clip_text.clip_text_from_hf"),
    "qwen2_5_7b": ("Qwen/Qwen2.5-7B-Instruct", "planning.llm.load_llm_from_hf"),
    "qwen2_vl_7b": ("Qwen/Qwen2-VL-7B-Instruct",
                    "planning.qwen2vl.load_qwen2vl_from_hf"),
}

#: manifests of the JAX package whose converters the port has not yet;
#: each comes with the ROADMAP item that ports its converter
PENDING = {
    "t5_v1_1_xxl": "A9 (t5_native.py)",
}

#: keys a checkpoint may carry that the converters deliberately skip
OPTIONAL = {
    "dinov2_small": {"embeddings.mask_token"},
}

#: extra-key prefixes a FULL-model download legitimately carries beside the
#: sub-tower a manifest describes (the text tower of a whole CLIP checkpoint
#: validated against the vision manifest).  Any other extra key fails: a key
#: superset from a wrong variant must not exit 0.
SIBLING_PREFIXES = {
    "clip_vit_b16_vision": ("text_model.", "text_projection",
                            "visual_projection", "logit_scale"),
    "clip_vit_b16_text": ("vision_model.", "text_projection",
                          "visual_projection", "logit_scale"),
    "siglip_so400m": ("text_model.", "logit_scale", "logit_bias"),
}


def load_manifest(name: str) -> Dict[str, Tuple[int, ...]]:
    if name in PENDING:
        raise NotImplementedError(
            f"manifest {name!r}: its converter is not ported yet (ROADMAP {PENDING[name]})")
    if name not in KNOWN:
        raise FileNotFoundError(f"unknown manifest {name!r}; available: {sorted(KNOWN)}")
    with open(os.path.join(MANIFEST_DIR, f"{name}.json")) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


@dataclasses.dataclass
class ManifestDiff:
    missing: list          # required by the manifest, absent in checkpoint
    extra: list            # unexplained keys unknown to the manifest (FAIL)
    shape_mismatch: list   # (key, got, want)
    sibling: list = dataclasses.field(default_factory=list)
    # ^ extras under a declared SIBLING_PREFIXES namespace (informational)

    @property
    def ok(self) -> bool:
        return not (self.missing or self.extra or self.shape_mismatch)

    def summary(self, name: str) -> str:
        if self.ok and not self.sibling:
            return f"{name}: OK (exact key space)"
        lines = [f"{name}: {'OK' if self.ok else 'MISMATCH'}"]
        for label, items in (("missing", self.missing),
                             ("unexplained extra", self.extra),
                             ("shape mismatch", self.shape_mismatch),
                             ("sibling-tower keys (ignored)", self.sibling)):
            if items:
                shown = ", ".join(str(i) for i in items[:5])
                more = f" (+{len(items) - 5} more)" if len(items) > 5 else ""
                lines.append(f"  {label} ({len(items)}): {shown}{more}")
        return "\n".join(lines)


def diff_keys(actual: Dict[str, Tuple[int, ...]], name: str) -> ManifestDiff:
    """Compare a {key: shape} mapping against manifest ``name``."""
    man = load_manifest(name)
    optional = OPTIONAL.get(name, set())
    sib_pfx = SIBLING_PREFIXES.get(name, ())
    missing = sorted(k for k in man if k not in actual and k not in optional)
    extras = sorted(k for k in actual if k not in man)
    sibling = [k for k in extras if k.startswith(sib_pfx)] if sib_pfx else []
    extra = [k for k in extras if k not in set(sibling)]
    mism = sorted((k, tuple(actual[k]), man[k])
                  for k in man if k in actual and tuple(actual[k]) != man[k])
    return ManifestDiff(missing, extra, mism, sibling)


def read_checkpoint_shapes(path: str) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of a checkpoint: safetensors dir/file (headers only)
    or a torch pickle."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
    elif path.endswith(".safetensors"):
        files = [path]
    else:
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        return {k: tuple(v.shape) for k, v in sd.items() if hasattr(v, "shape")}

    from vla_touch_tpu_torch.utils.safetensors_io import read_header

    shapes: Dict[str, Tuple[int, ...]] = {}
    for fp in files:
        for k, e in read_header(fp).items():
            if k != "__metadata__":
                shapes[k] = tuple(e["shape"])
    return shapes


def validate_checkpoint(path: str, name: str) -> ManifestDiff:
    return diff_keys(read_checkpoint_shapes(path), name)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("manifest", nargs="?", help=f"one of {sorted(KNOWN)}")
    p.add_argument("checkpoint", nargs="?",
                   help="safetensors dir/file or torch .pt/.bin")
    p.add_argument("--list", action="store_true",
                   help="list known manifests and exit")
    args = p.parse_args(argv)
    if args.list or not (args.manifest and args.checkpoint):
        for name, (ckpt, conv) in KNOWN.items():
            print(f"{name:22s} {ckpt}  ->  {conv}")
        for name, item in PENDING.items():
            print(f"{name:22s} not ported yet (ROADMAP {item})")
        return 0
    diff = validate_checkpoint(args.checkpoint, args.manifest)
    print(diff.summary(args.manifest))
    return 0 if diff.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
