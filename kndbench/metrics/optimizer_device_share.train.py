"""Share of the device's busy time spent in kernels launched under the
optimizer's ``update``, in the traced sub-window."""

MOVES = "train_tokens_per_s"


def read(r):
    t = r["trace"]
    if t is None or t.busy_s <= 0 or "optimizer" not in t.span_device_s:
        return None
    return t.span_device_s["optimizer"] / t.busy_s
