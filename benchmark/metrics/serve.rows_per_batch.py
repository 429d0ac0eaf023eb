"""Real rows per dispatched batch (rows with a frame present; the spare
rows of a bucket are all masked); the mean over the window's batches."""


def read(ctx):
    b = ctx.get("batches")
    if not b:
        return None
    return sum(len(x["rows"]) for x in b) / len(b)
