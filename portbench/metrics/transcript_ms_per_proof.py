"""Transcript step (`ops/transcript_cuda.py`, `csrc/transcript.cu`): device ms of the layer's kernels over the
traced calls, divided by the instance proofs they returned."""

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ("transcript_kernel",)


def read(trace):
    return trace.ms_per_proof(PATTERNS)
