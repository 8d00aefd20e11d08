"""The harness end to end on the CPU at a tiny size, past its look for a
card: a sound run is correct, and each fault a one-chip prover cell can
have, planted under the timed path, makes `correct` false. The control
(the lazy reference in the program's place) fails the check. Without a
card the command prints no result and exits with 2.

The faults: the transcript step returning its state unchanged; half of
the batch left out, its proofs taken from the other half; an answer
altered where it is produced. The exchange between chips has no place in
a one-chip cell.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as R

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = {"ml": "ml_2x3_nv20.batch16", "gkr": "gkr_dim20.batch8"}


def tiny(protocol: str, batch: int = 2) -> dict:
    spec = R.load_cell(CELLS[protocol])
    if protocol == "ml":
        spec["config"]["num_variables"] = 4
    else:
        spec["config"].update(dim=4, f1_nonzeros=16)
    spec["mix"]["batch"] = batch
    return spec


def _run(monkeypatch, protocol: str, batch: int = 2, seed: int = 2**31 + 77) -> dict:
    monkeypatch.setattr(R, "WARM_CALLS", 0)
    return R.run(tiny(protocol, batch), seed, 0.01, False, device="cpu")


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
def test_sound_run_is_correct(monkeypatch, protocol):
    result = _run(monkeypatch, protocol)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["proofs_checked"]["value"] >= 2
    assert list(result)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from sumcheck_tpu_torch.ops import transcript_cuda

    real = transcript_cuda.transcript_step_batched

    def step(state, *args, **kwargs):
        saved = state.clone()
        out = real(state, *args, **kwargs)
        state.copy_(saved)
        return out

    monkeypatch.setattr(transcript_cuda, "transcript_step_batched", step)


def _half_batch(monkeypatch, keep: str = "lower"):
    """Half of each call's batch left out: the kept half is proved and
    its proofs stand in for the other half's, or (`dropped`) the other
    half's proofs are not returned."""
    from sumcheck_tpu_torch import batch as B

    ml, gkr = B.BatchedMLSumcheck.prove_as_subprotocol, B.BatchedGKRRoundSumcheck.prove

    def halves(n):
        half = n // 2
        return (slice(half, n), n - half) if keep == "upper" else (slice(0, half), half)

    def stand_in(done, n):
        if keep == "dropped":
            return done
        return done + done[:n - len(done)] if keep == "lower" else done[:n - len(done)] + done

    def ml_half(rngs, polys, **kw):
        part, _k = halves(len(polys))
        proofs, chal = ml(rngs[part], polys[part], **kw)
        return stand_in(proofs, len(polys)), stand_in(chal, len(polys))

    def gkr_half(rngs, f1s, f2s, f3s, gs, **kw):
        part, _k = halves(len(f1s))
        return stand_in(gkr(rngs[part], f1s[part], f2s[part], f3s[part], gs[part], **kw),
                        len(f1s))

    monkeypatch.setattr(B.BatchedMLSumcheck, "prove_as_subprotocol", staticmethod(ml_half))
    monkeypatch.setattr(B.BatchedGKRRoundSumcheck, "prove", staticmethod(gkr_half))


def _answer_altered(monkeypatch):
    from sumcheck_tpu_torch.fields.fr import Fr
    from sumcheck_tpu_torch.protocol import device_prover

    real = device_prover.msgs_from_host

    def altered(msgs_h, degree):
        msgs = real(msgs_h, degree)
        msgs[0].evaluations[0] = msgs[0].evaluations[0] + Fr(1)
        return msgs

    monkeypatch.setattr(device_prover, "msgs_from_host", altered)


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_makes_the_run_incorrect(monkeypatch, protocol, fault):
    fault(monkeypatch)
    result = _run(monkeypatch, protocol)
    assert not result["correct"]
    assert result["checks"]["proofs_differing"]["value"] >= 1


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
@pytest.mark.parametrize("keep", ["lower", "upper", "dropped"])
@pytest.mark.parametrize("seed", [2**31 + 5, 3 * 2**31 + 17, 11])
def test_half_batch_fails_at_the_cells_batch(monkeypatch, protocol, keep, seed):
    """At the cell's own batch and sample, either half left out is caught
    on every seed: the sample holds a proof from each half, and a proof
    not returned is missing."""
    batch = R.load_cell(CELLS[protocol])["mix"]["batch"]
    _half_batch(monkeypatch, keep)
    result = _run(monkeypatch, protocol, batch, seed)
    assert not result["correct"]
    checks = result["checks"]
    if keep == "dropped":
        assert checks["proofs_missing"]["value"] == result["failed"] > 0
    else:
        assert checks["proofs_differing"]["value"] >= 1


@pytest.mark.parametrize("protocol", ["ml", "gkr"])
def test_control_fails_the_check(protocol):
    from portbench.control import control_counts

    out = control_counts(tiny(protocol), 9, 3, "cpu")
    assert not out["correct"]
    assert out["checks"]["proofs_differing"]["value"] == out["checks"]["proofs_checked"]["value"]


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS["ml"],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a card is present")
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.cuda
def test_control_fails_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.control import control_counts

    spec = tiny("ml")
    spec["config"]["num_variables"] = 16
    out = control_counts(spec, 10, 3, torch.device("cuda", 0))
    assert not out["correct"]


def test_result_line_is_json_of_the_contract_keys(monkeypatch):
    result = _run(monkeypatch, "ml")
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_sample_holds_a_proof_from_each_half(batch):
    from portbench.check import Sample

    for seed in range(20):
        sample = Sample(batch, seed)
        for call in range(50):
            for slot in range(batch):
                sample.offer((call, slot), None)
        slots = [slot for (_c, slot), _v in sample.items]
        assert 2 <= len(slots) <= 3
        assert min(slots) < batch // 2 <= max(slots)
