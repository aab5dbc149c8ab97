"""The SSD chunk kernel's share of its roofline, in %: the least time of
every ``ssd_chunk`` call in the traced sub-window (forward and its remat
recompute; FLOPs at the TF32 peak, its operands being f32, or bytes at
HBM bandwidth) over the device time of the kernels launched under them."""

MOVES = "train_tokens_per_s"


def read(r):
    t = r["trace"]
    least = r["counters"].get("least_s", {}).get("ssd_chunk")
    dev = t.span_device_s.get("ssd_chunk") if t is not None else None
    if not least or not dev:
        return None
    return 100.0 * least / dev
