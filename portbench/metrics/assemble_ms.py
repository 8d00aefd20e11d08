"""API and dispatch: the host building the proofs, challenges and
transcripts after the fetch, ms, the mean over the traced calls of the
port's `assemble` spans (`portbench/stages.py`)."""

from portbench import stages

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    return stages.stage_ms(trace, ("assemble",))
