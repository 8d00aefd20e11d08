"""Round kernels (`ops/round_cuda.py`, `csrc/round.cu`, `csrc/round_mxu.cu`): the layer's bound time for the traced calls
(`work.call_work`, at the card's published peaks) over its kernels'
device time, percent."""

UNIT = "%"
MOVES = "call_p95_ms"
PATTERNS = ("nofold_kernel", "fold_kernel", "fold_mxu", "wide_kernel", "round_kernel")
LAYER = "round"


def read(trace):
    return trace.roofline_pct(PATTERNS, LAYER)
