"""Engine tick time: the window's seconds over the engine ticks in it, in ms."""

MOVES = "tpot_p95_ms"


def read(r):
    c = r["counters"]
    return 1e3 * c["window_s"] / c["ticks"] if c.get("ticks") else None
