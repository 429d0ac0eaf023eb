"""The batched policy step as the pool calls it (ms), until its rows are
on the host; the mean over the window's batches that ran untraced."""


def read(ctx):
    b = [x for x in ctx.get("batches") or [] if not x["traced"]]
    return 1e3 * sum(x["t1"] - x["t0"] for x in b) / len(b) if b else None
