"""Share of the rows fed to the model that carry no token: 1 - real rows
(each slot's tokens fed in the tick) / (slots x the tick's chunk width),
summed over the window's ticks."""

MOVES = "serve_tokens_per_s"


def read(r):
    c = r["counters"]
    return 1.0 - c["real_rows"] / c["fed_rows"] if c.get("fed_rows") else None
