"""ML pair init (`ops/init_cuda.py`, `csrc/pair_init.cu`): the layer's bound time for the traced calls
(`work.call_work`, at the card's published peaks) over its kernels'
device time, percent."""

UNIT = "%"
MOVES = "call_p95_ms"
PATTERNS = ("pair_init",)
LAYER = "pair_init"


def read(trace):
    return trace.roofline_pct(PATTERNS, LAYER)
