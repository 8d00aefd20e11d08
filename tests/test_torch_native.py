"""The port's C transcript and verifier core (`sumcheck_tpu_torch/native/`,
its own copy of `fastrng.c`) against the Python cores and the JAX package.

- the C core's digests, draws, fills and `(h, t, buf)` state tuples equal
  `hashlib` (`_FastCore`) and the explicit-state core (`Blake2b512`), and
  the JAX package's transcript; `set_state` round-trips at every pending
  byte count;
- the verifier's C pass (`native_verify_phase`, with its check loop and
  interpolation) gives the results, transcript states and rejections of the
  Python loop (``SUMCHECK_TPU_NATIVE=off``) and of the JAX package;
- a compiler that fails raises, with its messages; ``SUMCHECK_TPU_NATIVE=off``
  alone selects the Python cores;
- the port and its C core import neither JAX nor `sumcheck_tpu`.

Every test also runs under BN254 Fr: `test_native_under_bn254` runs this
file in a child pytest with ``SUMCHECK_TPU_FIELD=bn254_fr``. Tolerance 0.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys

import numpy as np
import pytest

import sumcheck_tpu_torch as T
from sumcheck_tpu_torch import native
from sumcheck_tpu_torch.fields.fr import FIELD_NAME, P
from sumcheck_tpu_torch.protocol import verifier as V
from sumcheck_tpu_torch.protocol.prover import ProverMsg
from sumcheck_tpu_torch.transcript.blake2b_core import Blake2b512
from sumcheck_tpu_torch.transcript.blake2b_rng import _FastCore, _NativeCore, fr_rand

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python_rng(state=None):
    """A `Blake2b512Rng` on the Python cores: hashlib, or the explicit-state
    core continuing from `state`."""
    rng = T.Blake2b512Rng.__new__(T.Blake2b512Rng)
    rng._h = _FastCore() if state is None else Blake2b512.from_state(*state)
    return rng


def _poly(seed: int, nv: int):
    """Two products (of 2 and 3 multiplicands) from `default_rng(seed)`,
    tables below 2^253 < p under either field."""
    from sumcheck_tpu_torch.convert import polynomial_from_numpy

    gen = np.random.default_rng(seed)
    tables = []
    for _ in range(4):
        d = gen.integers(0, 1 << 16, size=(16, 1 << nv), dtype=np.uint32)
        d[15] >>= 3
        tables.append(d)
    return polynomial_from_numpy(nv, tables, [(3, [0, 1]), (11, [1, 2, 3])])


def test_native_core_matches_hashlib():
    rnd = random.Random(0)
    nat, ref = _NativeCore(native.lib()), _FastCore()
    for i in range(300):
        data = rnd.randbytes(rnd.randrange(0, 300))
        nat.update(data)
        ref.update(data)
        assert nat.digest_clone() == ref.copy().digest(), f"update {i}"
    assert nat.state_tuple() == ref.state_tuple()


def test_native_rng_matches_the_python_cores():
    rnd = random.Random(1)
    a, b = T.Blake2b512Rng.setup(), _python_rng()
    assert isinstance(a._h, _NativeCore)
    for i in range(120):
        msg = rnd.randbytes(rnd.randrange(1, 200))
        a.feed(msg)
        b.feed(msg)
        assert fr_rand(a) == fr_rand(b), f"draw {i}"
        if i % 5 == 0:
            n = rnd.choice([0, 1, 4, 8, 63, 64, 65, 127, 128, 777])
            assert a.fill_bytes(n) == b.fill_bytes(n), f"fill({n})"
            k = rnd.choice([1, 3, 4, 5])
            assert a.next_u64s_bytes(k) == b.next_u64s_bytes(k)
            assert a.next_u32() == b.next_u32()
    assert a.state_tuple() == b.state_tuple()


@pytest.mark.parametrize("pending", [0, 1, 8, 63, 64, 120, 127, 128, 129, 200, 256])
def test_state_tuple_round_trips(pending):
    """After `pending` fed bytes: the C core's (h, t, buf) equals the
    explicit core's; `set_state` from either core's tuple continues the
    same stream on the C core, and the tuple read back is the one set."""
    data = bytes(range(256))[:pending]
    a, ref = T.Blake2b512Rng.setup(), Blake2b512()
    a.feed_bytes(data)
    ref.update(data)
    state = a.state_tuple()
    assert state == ref.state_tuple()
    h, t, buf = state
    assert isinstance(t, int) and isinstance(buf, bytes) and len(buf) <= 128
    assert all(isinstance(w, int) for w in h) and len(h) == 8
    b = T.Blake2b512Rng.setup()
    b.set_state(*ref.state_tuple())
    assert isinstance(b._h, _NativeCore) and b.state_tuple() == state
    c = _python_rng(state)
    for _ in range(6):
        x = fr_rand(a)
        assert fr_rand(b) == x == fr_rand(c)
    assert a.state_tuple() == b.state_tuple() == c.state_tuple()


def test_native_rng_matches_the_jax_package():
    import sumcheck_tpu as J

    rnd = random.Random(2)
    a, j = T.Blake2b512Rng.setup(), J.Blake2b512Rng.setup()
    for _ in range(40):
        msg = rnd.randbytes(rnd.randrange(0, 150))
        a.feed(msg)
        j.feed(msg)
        assert T.Fr.rand(a).v == J.Fr.rand(j).v
        assert a.fill_bytes(9) == j.fill_bytes(9)
        assert a.state_tuple() == j.state_tuple()


def _verify_both_ways(monkeypatch, run):
    """`run()` with the C core, then with ``SUMCHECK_TPU_NATIVE=off``."""
    fast = run()
    with monkeypatch.context() as m:
        m.setenv("SUMCHECK_TPU_NATIVE", "off")
        slow = run()
    return fast, slow


def test_ml_verify_matches_the_python_loop_and_the_jax_package(monkeypatch):
    import sumcheck_tpu as J

    poly = _poly(3, 6)
    prover = T.Blake2b512Rng.setup()
    prover.feed_bytes(b"prefix")
    proof, _state = T.MLSumcheck.prove_as_subprotocol(prover, poly, device="cpu")
    s = T.MLSumcheck.extract_sum(proof)

    def run():
        rng = T.Blake2b512Rng.setup()
        rng.feed_bytes(b"prefix")
        sub = T.MLSumcheck.verify_as_subprotocol(rng, poly.info(), s, proof)
        return [x.v for x in sub.point], sub.expected_evaluation.v, rng.state_tuple()

    fast, slow = _verify_both_ways(monkeypatch, run)
    assert fast == slow
    jrng = J.Blake2b512Rng.setup()
    jrng.feed_bytes(b"prefix")
    jproof = J.ml_sumcheck.deserialize_proof(T.ml_sumcheck.serialize_proof(proof))
    jinfo = J.PolynomialInfo(poly.max_multiplicands, poly.num_variables)
    jsub = J.MLSumcheck.verify_as_subprotocol(jrng, jinfo, J.Fr(s.v), jproof)
    assert fast == ([x.v for x in jsub.point], jsub.expected_evaluation.v, jrng.state_tuple())
    assert poly.evaluate([T.Fr(v) for v in fast[0]]).v == fast[1]


def test_gkr_verify_matches_the_python_loop_and_the_jax_package(monkeypatch):
    import sumcheck_tpu as J

    rnd = random.Random(5)
    dim = 4
    f1 = T.SparseMLE.rand_with_config(3 * dim, 1 << dim, rnd)
    f2, f3 = T.DenseMLE.rand(dim, rnd), T.DenseMLE.rand(dim, rnd)
    g = [T.Fr(rnd.randrange(P)) for _ in range(dim)]
    proof = T.GKRRoundSumcheck.prove(T.Blake2b512Rng.setup(), f1, f2, f3, g, device="cpu")
    s = proof.extract_sum()

    def run():
        rng = T.Blake2b512Rng.setup()
        sub = T.GKRRoundSumcheck.verify(rng, dim, proof, s)
        assert sub.verify_subclaim(f1, f2, f3, g)
        return [x.v for x in sub.u + sub.v], sub.expected_evaluation.v, rng.state_tuple()

    fast, slow = _verify_both_ways(monkeypatch, run)
    assert fast == slow
    jrng = J.Blake2b512Rng.setup()
    jproof = J.GKRProof.deserialize_uncompressed(proof.serialize_uncompressed())
    jsub = J.GKRRoundSumcheck.verify(jrng, dim, jproof, J.Fr(s.v))
    assert fast == ([x.v for x in jsub.u + jsub.v], jsub.expected_evaluation.v,
                    jrng.state_tuple())


@pytest.mark.parametrize("where", ["first", "middle", "last", "sum"])
def test_rejections_match_the_python_loop(monkeypatch, where):
    """A corrupted round (or a wrong claimed sum) raises `Reject` in both
    loops, after the transcript has advanced through every round."""
    poly = _poly(4, 5)
    proof = T.MLSumcheck.prove(poly, device="cpu")
    s = T.MLSumcheck.extract_sum(proof)
    bad = T.ml_sumcheck.deserialize_proof(T.ml_sumcheck.serialize_proof(proof))
    if where == "sum":
        s = s + T.Fr.one()
    else:
        i = {"first": 0, "middle": 2, "last": 4}[where]
        bad[i].evaluations[1] = bad[i].evaluations[1] + T.Fr.one()

    def run():
        rng = T.Blake2b512Rng.setup()
        with pytest.raises(T.Reject):
            T.MLSumcheck.verify_as_subprotocol(rng, poly.info(), s, bad)
        return rng.state_tuple()

    fast, slow = _verify_both_ways(monkeypatch, run)
    assert fast == slow


def test_interpolation_and_check_loop_match_python(monkeypatch):
    """The C pass's interpolation and check loop (`fr_verify_rounds`) at
    every degree from 1 to 11, on random messages made consistent round by
    round with the Python interpolation, against the Python loop."""
    rnd = random.Random(6)
    for d1 in range(2, 13):
        nv = 5
        mirror = _python_rng()
        expected = asserted = rnd.randrange(P)
        msgs = []
        for _ in range(nv):
            vals = [rnd.randrange(P) for _ in range(d1)]
            vals[1] = (expected - vals[0]) % P
            msg = ProverMsg([T.Fr(v) for v in vals])
            msgs.append(msg)
            mirror.feed(msg)
            expected = V._interp_eval_int(vals, T.Fr.rand(mirror).v)

        def run():
            rng = T.Blake2b512Rng.setup()
            st = T.IPForMLSumcheck.verifier_init(T.PolynomialInfo(d1 - 1, nv))
            for msg in msgs:
                rng.feed(msg)
                T.IPForMLSumcheck.verify_round(msg, st, rng)
            sub = T.IPForMLSumcheck.check_and_generate_subclaim(st, T.Fr(asserted))
            return [x.v for x in sub.point], sub.expected_evaluation.v, rng.state_tuple()

        rng = T.Blake2b512Rng.setup()
        point, final = V.native_verify_phase(rng, msgs, d1, asserted)
        assert (point, final, rng.state_tuple()) == run(), f"d + 1 = {d1}"
        assert final == expected and rng.state_tuple() == mirror.state_tuple()
        with monkeypatch.context() as m:
            m.setenv("SUMCHECK_TPU_NATIVE", "off")
            assert run() == (point, final, mirror.state_tuple())


@pytest.mark.parametrize("cc", ["false", "/nonexistent/cc"])
def test_a_failed_build_raises(tmp_path, monkeypatch, cc):
    monkeypatch.setenv("CC", cc)
    with pytest.raises(native.NativeBuildError, match="C core"):
        native.build(tmp_path)
    assert not list(tmp_path.iterdir())  # no library, no temporary file left
    # a transcript needs the core: it raises rather than fall back
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(native.NativeBuildError):
        T.Blake2b512Rng.setup()


def test_a_compiler_error_is_reported(tmp_path, monkeypatch):
    """The compiler's own messages come with the error."""
    fake = tmp_path / "cc"
    fake.write_text("#!/bin/sh\necho 'fastrng.c:1: error: no such thing' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CC", str(fake))
    with pytest.raises(native.NativeBuildError, match="exit code 3") as e:
        native.build(tmp_path / "out")
    assert "no such thing" in str(e.value)


def test_off_selects_the_python_cores(monkeypatch):
    monkeypatch.setenv("SUMCHECK_TPU_NATIVE", "off")
    assert native.lib() is None and not native.enabled()
    rng = T.Blake2b512Rng.setup()
    assert isinstance(rng._h, _FastCore)
    rng.feed_bytes(b"x" * 40)
    state = rng.state_tuple()
    rng.set_state(*state)
    assert isinstance(rng._h, Blake2b512) and rng.state_tuple() == state
    assert V.native_verify_phase(rng, [], 3, 0) is None
    monkeypatch.setenv("SUMCHECK_TPU_NATIVE", "on")
    assert isinstance(T.Blake2b512Rng.setup()._h, _NativeCore)


def test_the_port_and_its_c_core_import_no_jax():
    code = """
import sys
import sumcheck_tpu_torch as T
from sumcheck_tpu_torch.transcript.blake2b_rng import _NativeCore
rng = T.Blake2b512Rng.setup()
assert isinstance(rng._h, _NativeCore)
rng.feed_bytes(b"abc")
T.Fr.rand(rng)
from sumcheck_tpu_torch.protocol.verifier import native_verify_phase
assert native_verify_phase(T.Blake2b512Rng.setup(), [], 3, 5) == ([], 5)
bad = sorted(m for m in sys.modules if m in ("jax", "sumcheck_tpu")
             or m.startswith(("jax.", "sumcheck_tpu.")))
print(bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


NATIVE_TESTS = sorted(n for n in list(globals()) if n.startswith("test_"))


@pytest.fixture(scope="module")
def bn254_outcomes(tmp_path_factory):
    from test_torch_field import child_outcomes

    return child_outcomes(__file__, tmp_path_factory.mktemp("bn254"), "not under_bn254")


@pytest.mark.parametrize("name", NATIVE_TESTS)
def test_native_under_bn254(bn254_outcomes, name):
    """Every case of test `name` passed in the child under BN254 Fr (its
    p, shave mask and -p^-1 mod 2^64 reach every C draw and check)."""
    from test_torch_field import outcomes_of

    assert FIELD_NAME == "bls12_381_fr"
    cases = outcomes_of(bn254_outcomes, name)
    assert cases and set(cases.values()) == {"passed"}, cases
