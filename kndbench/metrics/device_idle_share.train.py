"""1 - (union of device activity intervals) / (traced sub-window)."""

MOVES = "train_tokens_per_s"


def read(r):
    t = r["trace"]
    return None if t is None or t.window_s <= 0 else 1.0 - t.busy_s / t.window_s
