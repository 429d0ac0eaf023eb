"""The whole served step's share of the H100's bf16 peak (%): the model
FLOPs of the traced batches' real rows (benchmark/roofline.py:
``served_chunk_flops`` at each row's real language length) over the traced
span's wall time and 989 TFLOP/s."""

from benchmark import roofline as RL


def read(ctx):
    tr, batches = ctx.get("trace"), ctx.get("traced_batches")
    if tr is None or not batches:
        return None
    flops = sum(RL.served_chunk_flops(ctx["config"], L) for b in batches for L in b["lens"])
    return 100.0 * flops / (tr["window_s"] * RL.BF16_FLOPS)
