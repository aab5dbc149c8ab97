"""The flash forward's share of its roofline, in %: the least time of
every ``flash_attention`` call in the traced sub-window (forward and its
remat recompute; FLOPs at the bf16 peak or bytes at HBM bandwidth) over
the device time of the kernels launched under those calls."""

MOVES = "train_tokens_per_s"


def read(r):
    t = r["trace"]
    least = r["counters"].get("least_s", {}).get("flash_attention")
    dev = t.span_device_s.get("flash_attention") if t is not None else None
    if not least or not dev:
        return None
    return 100.0 * least / dev
