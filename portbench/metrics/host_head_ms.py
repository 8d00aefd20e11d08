"""API and dispatch: from a call's start to its first device operation,
ms, the mean over the traced calls (the host's work before the card can
start: transcripts lifted, uploads and the first launches enqueued)."""

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    heads = [c.records[0][0] - c.start for c in trace.calls if c.records]
    return sum(heads) / len(heads) / 1e3 if heads else None
