"""The program's configuration objects built from a configuration file, and
its modules built from seeded weights."""

from __future__ import annotations

import gc

import torch

from benchmark import traffic as TR
from benchmark import weights as W
from benchmark.reference import model as M

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def runner_config(config: dict):
    from vla_touch_tpu_torch.config import NoiseSchedulerConfig, RDTModelConfig
    from vla_touch_tpu_torch.models.rdt.runner import RDTRunnerConfig

    rdt = dict(config["rdt"])
    grid = rdt.pop("img_pos_embed_grid")
    return RDTRunnerConfig(model=RDTModelConfig(img_pos_embed_grid=None if grid is None
                                                else tuple(grid), **rdt),
                           noise=NoiseSchedulerConfig(**config["noise"]))


def vision_config(config: dict):
    """SigLIP's tower: no class token, no layer scale, tanh GELU."""
    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig

    v = config["vision"]
    return ViTConfig(hidden_size=v["hidden_size"], num_layers=v["num_layers"],
                     num_heads=v["num_heads"], mlp_dim=v["mlp_dim"],
                     patch_size=v["patch_size"], image_size=v["image_size"],
                     num_channels=v["num_channels"], layernorm_eps=v["layernorm_eps"],
                     use_cls_token=False, use_layerscale=False, gelu_tanh=True)


def policy_config(config: dict):
    from vla_touch_tpu_torch.runtime.policy import PolicyConfig

    p = config["policy"]
    return PolicyConfig(rdt=runner_config(config), vision=vision_config(config),
                        state_indices=tuple(p["state_indices"]),
                        state_scale=tuple(float(s) for s in p["state_scale"]),
                        action_scale=(None if p["action_scale"] is None
                                      else tuple(p["action_scale"])),
                        control_frequency=p["control_frequency"],
                        image_size=p["image_size"], img_history_size=p["img_history_size"],
                        num_cameras=p["num_cameras"])


def rdt_weights(config: dict, seed: int, device, dtype) -> dict:
    return W.make(M.rdt_shapes(config["rdt"]), TR.sub_seed(seed, "rdt"), device, dtype)


def siglip_weights(config: dict, seed: int, device, dtype) -> dict:
    return W.make(M.siglip_shapes(config["vision"]), TR.sub_seed(seed, "siglip"), device, dtype)


def modules(config: dict, seed: int, device, rdt_dtype):
    """The program's RDT runner (in ``rdt_dtype``) and SigLIP tower (in the
    vision dtype), with the RDT's name map; the checkpoint-layout tensors
    are freed once copied in."""
    rcfg = runner_config(config)
    hf = rdt_weights(config, seed, device, rdt_dtype)
    rdt, mapping = W.rdt_module(rcfg, hf, device, rdt_dtype)
    del hf
    vdt = DTYPES[config["vision"]["dtype"]]
    hf = siglip_weights(config, seed, device, vdt)
    vision, _ = W.siglip_module(vision_config(config), hf, device, vdt)
    del hf
    return rdt, vision, mapping


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class TowerTimer:
    """CUDA events at the tower's forward pre- and post-hooks (no
    synchronise); :meth:`ms` reads them once the device is done."""

    def __init__(self, tower: torch.nn.Module):
        self.pairs = []
        self.handles = [tower.register_forward_pre_hook(self._pre),
                        tower.register_forward_hook(self._post)]

    def _pre(self, module, args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs.append([e, None])

    def _post(self, module, args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs[-1][1] = e

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs if b is not None]

    def remove(self):
        for h in self.handles:
            h.remove()
