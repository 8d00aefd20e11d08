"""Does `torch.profiler` keep a profile's device records in this process?

    KINETO_LOG_LEVEL=0 python tools/torch_profiler_check.py

Profiles four launches (the marker kernel of `torch.cuda._sleep`, the
port's empty kernel and two torch ops) in one process: fresh, after a
profiled GKR dim-18 prove (about 26,000 launches), and after
`dryrun_multichip(2)` has spawned two ranks on the card. Each line gives
the device records the profile kept, its host-side runtime calls and the
records matched to a call by correlation id, as `microbench.
profile_events` counts them; with `KINETO_LOG_LEVEL=0` the profiler also
logs its "Out-of-range" count of the records it dropped. The microbench
runs in a process of its own because of what this shows. Needs a CUDA
device."""

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sumcheck_tpu_torch import Blake2b512Rng, GKRRoundSumcheck  # noqa: E402  (from the repo)
from sumcheck_tpu_torch import entry as E  # noqa: E402
from sumcheck_tpu_torch import microbench as MB  # noqa: E402
from sumcheck_tpu_torch.ops import transcript_cuda as tc  # noqa: E402

REPEATS = 4


def kept(device) -> tuple[int, int, int]:
    """(device records kept, host-side runtime calls, records matched to a
    call by correlation id) of a profile of four launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(1000)
        tc._empty_launch(device)
        torch.ones(16, device=device).add_(1)
        torch.cuda.synchronize()
    events = list(prof.events())
    calls = {e.id for e in events if e.device_type != DeviceType.CUDA and e.name in MB.RUNTIME_CALLS}
    records = [e for e in events if e.device_type == DeviceType.CUDA]
    return len(records), len(calls), sum(e.id in calls for e in records)


def report(label: str, device) -> None:
    print(f"{label}: (device records kept, runtime calls, records matched to a call) of 4 "
          f"launches, {REPEATS} profiles: "
          f"{[kept(device) for _ in range(REPEATS)]}", flush=True)


def main() -> int:
    device = torch.device("cuda", 0)
    report("fresh", device)
    f1, f2, f3, g = MB.gkr_instance(18)
    GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        GKRRoundSumcheck.prove(Blake2b512Rng.setup(), f1, f2, f3, g, device=device)
        torch.cuda.synchronize()
    records = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    report(f"after a profiled GKR dim-18 prove ({records} device records)", device)
    E.dryrun_multichip(2)
    report("after dryrun_multichip(2) on the card", device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
