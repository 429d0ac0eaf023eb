"""95th percentile of submit to the Future's result (ms) over every
request completed in the window.  The closed loop keeps the pool full, so
this tail is one or two pool cycles and swings with the host: a per-layer
reading beside ``chunks_per_s``, not a bound."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
