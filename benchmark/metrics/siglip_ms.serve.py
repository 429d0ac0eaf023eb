"""The SigLIP tower's device time per call (ms): CUDA events at its
forward pre- and post-hooks, one call a batch; the mean over the traced run's window."""


def read(ctx):
    if "batches" not in ctx or not ctx.get("siglip_ms"):
        return None
    ms = ctx["siglip_ms"]
    return sum(ms) / len(ms)
