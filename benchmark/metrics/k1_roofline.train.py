"""K1's share of its roofline over the traced steps (%), as
``k1_roofline.serve`` counts it.  Calls a step: SigLIP's layers over every
frame of the step's rows, and per micro-batch each RDT block's self- and
cross-attention forward (the backward is the program's plain float32
attention, not K1)."""

from benchmark import roofline as RL
from benchmark.trace import kernel_s


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("traced_steps")
    if tr is None or not steps:
        return None
    cfg, vcfg, pol = ctx["config"]["rdt"], ctx["config"]["vision"], ctx["config"]["policy"]
    frames = pol["img_history_size"] * pol["num_cameras"]
    mb = ctx["micro_batch"]
    calls = []
    for lens in steps:
        calls += RL.siglip_k1_calls(vcfg, frames * len(lens))
        for s in range(0, len(lens), mb):
            calls += RL.rdt_k1_calls(cfg, lens[s:s + mb], 1)
    sec, n = kernel_s(tr, "flash_fwd_kernel", "flash_combine_kernel")
    if sec <= 0:
        return None
    return 100.0 * RL.least_s(calls)[0] / sec
