"""GKR phase inits (`ops/gkr_init_cuda.py`, `csrc/gkr_init.cu`): the layer's bound time for the traced calls
(`work.call_work`, at the card's published peaks) over its kernels'
device time, percent."""

UNIT = "%"
MOVES = "call_p95_ms"
PATTERNS = ("weight_reduce", "finish_sums", "pair_slots")
LAYER = "gkr_init"


def read(trace):
    return trace.roofline_pct(PATTERNS, LAYER)
