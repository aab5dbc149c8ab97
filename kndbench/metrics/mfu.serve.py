"""Useful model FLOPs of the tokens fed in the window over the window's
length at the bf16 tensor-core peak, in %."""

from kndbench import peaks

MOVES = "serve_tokens_per_s"


def read(r):
    c = r["counters"]
    if not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / (c["window_s"] * peaks.BF16_FLOPS)
