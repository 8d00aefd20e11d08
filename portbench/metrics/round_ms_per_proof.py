"""Round kernels (`ops/round_cuda.py`, `csrc/round.cu`, `csrc/round_mxu.cu`): device ms of the layer's kernels over the
traced calls, divided by the instance proofs they returned."""

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ("nofold_kernel", "fold_kernel", "fold_mxu", "wide_kernel", "round_kernel")


def read(trace):
    return trace.ms_per_proof(PATTERNS)
