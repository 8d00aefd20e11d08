"""Chain loop: kernel launches a call (copies and fills not counted), the
mean over the traced calls. A batched chain launches a fixed number a
call; a fall back to the per-instance host loop launches many more."""

UNIT = "kernels"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    return len(trace.kernels()) / len(trace.calls) if trace.calls else None
