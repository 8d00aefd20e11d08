"""One checkout's transcript step on the card, for comparing two commits of
the PyTorch/CUDA port (`sumcheck_tpu_torch`) on one H100.

    python tools/transcript_ab.py <checkout root> <label> [degree ...]

Imports the port from <checkout root>, builds its transcript kernel there,
and for each degree (default 3, 9 and 20: the main path's static stream and
the two degrees past it that `chip_smoke.py` phase 6f times) runs 24 rounds
of `transcript_cuda.transcript_step` from one state, over the inputs of
`chip_smoke.py`'s transcript phase (`transcript_inputs`), in five passes.
Each pass is timed on the device with the stream held while its launches
are enqueued (`chip_smoke.time_ms(..., device_only=True)`, through the
measured checkout's `microbench.held_ms`). Prints one JSON line: the label,
the card's name and power limit, and per degree the median ms a round and
every pass. Compare two commits in one call, alternating them: parent,
change, change, parent."""

import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(sys.argv[1]).resolve()
LABEL = sys.argv[2]
DEGREES = [int(d) for d in sys.argv[3:]] or [3, 9, 20]
ROUNDS, PASSES = 24, 5
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
sys.path.insert(0, str(ROOT))

from sumcheck_tpu_torch import Blake2b512Rng  # noqa: E402  (from ROOT)
from sumcheck_tpu_torch.ops import transcript_cuda as tc  # noqa: E402
from sumcheck_tpu_torch.protocol.device_prover import lift_transcript  # noqa: E402


def per_round_ms(device, degree: int) -> list[float]:
    """Device ms a round of `ROUNDS` rounds from one state, `PASSES` times."""
    sums_h, prefix = smoke.transcript_inputs(0, ROUNDS, degree)
    sums = torch.from_numpy(sums_h).to(device)
    host = Blake2b512Rng.setup()
    host.feed_bytes(prefix)
    state0 = lift_transcript(host, device)
    msgs = torch.empty((ROUNDS, 16, degree + 1), dtype=torch.int32, device=device)
    rs = torch.empty((ROUNDS, 16), dtype=torch.int32, device=device)
    tc.transcript_step(state0.clone(), sums[0], msgs, rs, 0)  # loads the kernel
    torch.cuda.synchronize(device)

    def rounds_from(st):
        it = iter(range(ROUNDS))

        def step():
            j = next(it)
            tc.transcript_step(st, sums[j], msgs, rs, j)
        return step

    return [smoke.time_ms(rounds_from(st), ROUNDS, device, device_only=True, warm=False)
            for st in [state0.clone() for _ in range(PASSES)]]


def main() -> None:
    assert Path(tc.__file__).resolve().is_relative_to(ROOT), tc.__file__
    device = torch.device("cuda", 0)
    tc.build()
    out = {"label": LABEL, "card": smoke.card_line(), "ms": {}, "passes": {}}
    for degree in DEGREES:
        passes = per_round_ms(device, degree)
        out["ms"][degree] = statistics.median(passes)
        out["passes"][degree] = passes
    print(json.dumps(out))


if __name__ == "__main__":
    main()
