"""GKR phase inits (`ops/gkr_init_cuda.py`, `csrc/gkr_init.cu`): device ms of the layer's kernels over the
traced calls, divided by the instance proofs they returned."""

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ("weight_reduce", "finish_sums", "pair_slots")


def read(trace):
    return trace.ms_per_proof(PATTERNS)
