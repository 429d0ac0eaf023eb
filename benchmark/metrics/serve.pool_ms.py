"""The pool's time per batch outside the batched step (ms): from one
step's end to the next step's start, the dispatcher's coalescing wait,
padding, copies and the hand-back of rows; the mean over the window's
batches that ran untraced, leaving out the gaps where the tracer started
or stopped."""


def read(ctx):
    b = ctx.get("batches") or []
    gaps = [y["t0"] - x["t1"] for x, y in zip(b, b[1:])
            if not (x["traced"] or y["traced"] or y["after_toggle"])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
