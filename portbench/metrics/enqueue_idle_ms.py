"""Chain loop: the card waiting on the host's enqueue, ms, the mean over
the traced calls of the time inside the port's `feed`, `lift`, `inputs`,
`init` and `chain` spans when no kernel, copy or fill ran
(`portbench/stages.py`)."""

from portbench import stages

UNIT = "ms"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    return stages.idle_ms(trace, stages.ENQUEUE)
