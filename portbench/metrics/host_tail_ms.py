"""API and dispatch: from a call's last device operation to its return,
ms, the mean over the traced calls (the proofs and transcripts assembled
on the host after the one fetch)."""

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    tails = [c.end - max(e for _s, e, _n in c.records) for c in trace.calls if c.records]
    return sum(tails) / len(tails) / 1e3 if tails else None
