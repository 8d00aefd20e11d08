"""The port's benchmark: one cell of `BENCHMARK.json`, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(`portbench/configs/<config>.json`: the shapes and the program's
settings) and a traffic mix (`portbench/traffic/<mix>.json`: the batch of
a call); per-layer metrics are
read by `portbench/metrics/<metric>.py`, each found by its name in
`BENCHMARK.json`. Set-up makes the pool of instances from the seed,
uploads its tables and warms the cell's shapes; then one caller calls the
batched prover in a closed loop for `--seconds`. With `--trace 1` a block
of consecutive calls runs under the profiler and the run reports the
per-layer metrics instead of the end-to-end ones. After the window a
sample of the proofs is checked against the plain reference
(`portbench/check.py`).

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
The run needs a CUDA card: without one (or with fewer than the cell asks
for) it prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "sumcheck_tpu")
WARM_CALLS = 2  # set-up's calls, on inputs of their own
TRACED_CALLS = 8  # consecutive calls under the profiler in a --trace 1 run


class NoCard(RuntimeError):
    pass


def load_cell(name: str) -> dict:
    """The cell `name` of `BENCHMARK.json`: its entry, configuration, mix,
    and the end-to-end and per-layer metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def apply_environment(config: dict) -> None:
    """The program's settings the configuration states (field, chain, MXU
    fold, C core), set before the port is imported."""
    for key, value in config.get("environment", {}).items():
        os.environ[key] = value


def load_reader(metric: str):
    """`portbench/metrics/<metric>.py` as a module."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in `sys.modules`, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def p95(values) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def window_line(walls) -> str:
    """The median call wall of each second of the window, in ms: how the
    host's speed drifted while it ran."""
    medians, second, clock, cut = [], [], 0.0, 1.0
    for w in walls:
        clock += w
        second.append(w)
        if clock >= cut:
            medians.append(statistics.median(second) * 1e3)
            second, cut = [], cut + 1.0
    return f"{len(walls)} calls, median ms a second: " + " ".join(f"{m:.1f}" for m in medians)


def run(spec: dict, seed: int, seconds: float, trace: bool, device=None) -> dict:
    """One run of a loaded cell (`load_cell`); returns the result. `device`
    None means the card, after checking it is there; the tests pass the
    CPU, where memory and traces are not read."""
    config, mix = spec["config"], spec["mix"]
    apply_environment(config)
    import torch

    from portbench.check import Sample, compare, reference_outputs, verdict
    from portbench.inputs import call_inputs, make_pool
    from portbench.program import Program
    from portbench.work import call_work

    on_card = device is None
    if on_card:
        device = card(spec["cell"]["chips"])
        torch.cuda.set_device(device)
    batch = mix["batch"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    marks = [("start", time.perf_counter())]
    pool = make_pool(config, batch, seed, device)
    marks.append(("pool", time.perf_counter()))
    program = Program(config, pool, device)
    marks.append(("program", time.perf_counter()))
    program.upload()
    sync()
    marks.append(("upload", time.perf_counter()))
    for w in range(WARM_CALLS):
        program.call(program.prepare(call_inputs(config, batch, seed, w, warm=True)))
        sync()
        marks.append((f"warm{w}", time.perf_counter()))
    setup_s = time.perf_counter() - T0
    print("set-up: " + ", ".join(f"{name} {t - T0:.2f} s" for name, t in marks),
          file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    if trace:
        from torch.profiler import record_function

        from portbench.trace import SPAN, profile_calls
    sample = Sample(batch, seed)
    walls: list[float] = []
    tally = {"attempted": 0, "failed": 0, "errors": 0}

    def step():
        i = len(walls)
        args = program.prepare(call_inputs(config, batch, seed, i))
        span = record_function(SPAN) if trace else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with span:
                out = program.call(args)
        except Exception:  # a failed call is counted and shown, and the run goes on
            traceback.print_exc()
            tally["errors"] += 1
            out = []
        walls.append(time.perf_counter() - t0)
        tally["attempted"] += batch
        tally["failed"] += batch - len(out)
        for b, record in enumerate(out):
            sample.offer((i, b), record)

    traced = None
    start = time.perf_counter()
    step()
    if trace:
        traced = profile_calls(step, TRACED_CALLS, batch, call_work(config, batch))
    while time.perf_counter() - start < seconds and tally["errors"] < 3:
        step()
    sync()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    done = tally["attempted"] - tally["failed"]
    values = {"proofs_per_s": done / window_s, "call_p95_ms": p95(walls) * 1e3,
              "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    print("window: " + window_line(walls), file=sys.stderr)
    print("window: " + ", ".join(f"{k} {v!r}" for k, v in values.items()), file=sys.stderr)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that no run may hold: {', '.join(found)}")

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = load_reader(m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    keys = [k for k, _r in sample.items]
    got = [program.judge(r) for _k, r in sample.items]
    del program, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_outputs(config, batch, seed, pool, keys, device) if keys else []
    sync()
    correct, checks = verdict(compare(got, want), len(keys), tally["failed"])
    if tally["errors"]:
        correct = False
    print(f"reference: {len(keys)} proofs in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": spec["cell"]["chips"], "memory_peak_bytes": max(peak, setup_peak)}
    result = {"correct": correct, "attempted": tally["attempted"], "failed": tally["failed"],
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_us() / 1e6, window_s=traced.window_us / 1e6)
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks  # last: the numbers compared, each with its limit
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    try:
        result = run(spec, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(str(e), file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        bound = "at least" if name == "proofs_checked" else "at most"
        print(f"check {name} {c['value']} ({bound} {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
