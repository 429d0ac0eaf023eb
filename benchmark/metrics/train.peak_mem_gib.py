"""The device memory the finetuning steps hold at their peak (GiB):
``max_memory_allocated`` over the traced run's window, after a reset at its
start."""


def read(ctx):
    b = ctx.get("peak_bytes")
    return None if not b else b / 2 ** 30
