"""Device: the share of the traced calls' span in which no kernel, copy or
fill ran on the card, percent."""

UNIT = "%"
MOVES = "call_p95_ms"
PATTERNS = ()


def read(trace):
    if not trace.records() or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
