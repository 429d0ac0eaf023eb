"""K1's share of its roofline over the traced batches (%): the sum of each
K1 call's least time (benchmark/roofline.py: the larger of its bytes and
its operations over the H100's peaks, at the model's head dims, real rows
and real language tokens) over K1's device time in the trace
(``flash_fwd_kernel`` and ``flash_combine_kernel``).  Calls a batch:
SigLIP's layers over its frames, and per solver step each RDT block's
self- and cross-attention."""

from benchmark import roofline as RL
from benchmark.trace import kernel_s


def read(ctx):
    tr, batches = ctx.get("trace"), ctx.get("traced_batches")
    if tr is None or not batches:
        return None
    cfg, vcfg, pol = ctx["config"]["rdt"], ctx["config"]["vision"], ctx["config"]["policy"]
    frames = pol["img_history_size"] * pol["num_cameras"]
    steps = ctx["config"]["noise"]["num_inference_timesteps"]
    calls = []
    for b in batches:
        calls += RL.siglip_k1_calls(vcfg, frames * len(b["rows"]))
        calls += RL.rdt_k1_calls(cfg, b["lens"], steps)
    sec, n = kernel_s(tr, "flash_fwd_kernel", "flash_combine_kernel")
    if sec <= 0:
        return None
    return 100.0 * RL.least_s(calls)[0] / sec
