"""The device's idle share of the traced span (%): 1 - the union of its
activity intervals over the span's wall time."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or "traced_steps" not in ctx:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
