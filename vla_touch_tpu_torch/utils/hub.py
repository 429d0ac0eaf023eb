"""HF-Hub upload of a finished training run (counterpart of
``vla_touch_tpu/utils/hub.py``): create the repo if needed, write a model
card beside the checkpoint, and upload the output directory filtered to the
checkpoint and metadata patterns.

``huggingface_hub`` is imported when a push starts, and its absence raises
``RuntimeError``; the model card needs nothing.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

# checkpoint and metadata files only: the trainer's checkpoint-* directories
# (params / ema / opt_state msgpack + meta.json), HF-layout safetensors
# files, metrics and the card
DEFAULT_ALLOW_PATTERNS = (
    "*.msgpack", "*.safetensors", "*.json", "*.md", "*.jsonl",
    "checkpoint-*/**",
)

_CARD_TEMPLATE = """---
license: mit
base_model: {base_model}
tags:
- robotics
- vla
- diffusion-policy
- pytorch
---

# RDT — {repo_id}

RDT diffusion-policy checkpoint trained with vla_touch_tpu_torch (PyTorch).

- base model: {base_model}
- framework: pytorch (checkpoint-* directories of flax msgpack trees, or an
  HF-layout safetensors file)

Read a checkpoint directory's trees with
`vla_touch_tpu_torch.utils.checkpoint.load_pytree` (or resume it with
`vla_touch_tpu_torch.train.rdt_loop`); write and read the reference HF
layout with `vla_touch_tpu_torch.utils.torch_port` (`save_rdt_checkpoint`,
`load_rdt_runner`).
"""


def save_model_card(repo_id: str, base_model: Optional[str], repo_folder: str) -> str:
    """Write the README.md model card into ``repo_folder``; returns its
    path."""
    path = os.path.join(repo_folder, "README.md")
    with open(path, "w") as f:
        f.write(_CARD_TEMPLATE.format(repo_id=repo_id,
                                      base_model=base_model or "(from scratch)"))
    return path


def push_checkpoint_to_hub(output_dir: str, hub_model_id: Optional[str] = None,
                           token: Optional[str] = None, base_model: Optional[str] = None,
                           allow_patterns: Sequence[str] = DEFAULT_ALLOW_PATTERNS,
                           commit_message: str = "End of training") -> str:
    """Create (or reuse) the hub repo and upload ``output_dir``; the repo id
    defaults to the directory's basename.  Returns the resolved repo id.
    Raises ``RuntimeError`` without ``huggingface_hub``."""
    try:
        import huggingface_hub as hh
    except ImportError as e:
        raise RuntimeError("--push_to_hub requires the huggingface_hub package and "
                           "network access") from e

    want = hub_model_id or os.path.basename(os.path.normpath(output_dir))
    repo_id = hh.create_repo(repo_id=want, exist_ok=True, token=token).repo_id
    save_model_card(repo_id, base_model, output_dir)
    hh.upload_folder(repo_id=repo_id, folder_path=output_dir,
                     commit_message=commit_message, token=token,
                     allow_patterns=list(allow_patterns))
    return repo_id
