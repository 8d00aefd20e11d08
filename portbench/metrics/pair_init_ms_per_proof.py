"""ML pair init (`ops/init_cuda.py`, `csrc/pair_init.cu`): device ms of the layer's kernels over the
traced calls, divided by the instance proofs they returned."""

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ("pair_init",)


def read(trace):
    return trace.ms_per_proof(PATTERNS)
