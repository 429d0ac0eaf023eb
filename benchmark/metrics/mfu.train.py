"""The whole finetuning step's share of the H100's bf16 peak (%): the
model FLOPs of the traced steps (benchmark/roofline.py:
``train_step_flops``, RDT's forward and backward at each row's real
language length and the frozen SigLIP's forward over every frame) over the
traced span's wall time and 989 TFLOP/s."""

from benchmark import roofline as RL


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("traced_steps")
    if tr is None or not steps:
        return None
    pol = ctx["config"]["policy"]
    frames = pol["img_history_size"] * pol["num_cameras"]
    flops = sum(sum(RL.train_step_flops(ctx["config"], lens, frames * len(lens)).values())
                for lens in steps)
    return 100.0 * flops / (tr["window_s"] * RL.BF16_FLOPS)
