"""The port's Fiat-Shamir transcript (`sumcheck_tpu_torch.transcript`)
against the golden fixtures `transcript.json` and `fr_rand.json`, against
`hashlib`, and against the JAX package's transcript."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

import sumcheck_tpu as J
from sumcheck_tpu_torch import Blake2b512Rng, Fr
from sumcheck_tpu_torch.transcript.blake2b_core import Blake2b512
from sumcheck_tpu_torch.transcript.serialize import serialize_fr_vec, serialize_u8_vec

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name: str) -> dict:
    with open(os.path.join(FIXDIR, name)) as f:
        return json.load(f)


def test_transcript_fixture():
    fx = _load("transcript.json")
    rng = Blake2b512Rng.setup()
    for op in fx["ops"]:
        if op["op"] == "feed_bytes":
            rng.feed_bytes(bytes.fromhex(op["data"]))
        elif op["op"] == "next_u64":
            assert rng.next_u64() == op["value"]
        elif op["op"] == "fill_bytes":
            assert rng.fill_bytes(op["n"]).hex() == op["data"]
        elif op["op"] == "fr_rand":
            assert Fr.rand(rng).v == int(op["canonical"], 16)
        else:  # pragma: no cover
            raise AssertionError(f"unknown op {op['op']}")


def test_fr_rand_fixture():
    fx = _load("fr_rand.json")
    rng = Blake2b512Rng.setup()
    rng.feed_bytes(bytes.fromhex(fx["seed_feed"]))
    for want in fx["draws_canonical"]:
        assert Fr.rand(rng).v == int(want, 16)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 300])
def test_explicit_core_matches_hashlib(n):
    data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    core = Blake2b512()
    core.update(data[: n // 3])
    core.update(data[n // 3 :])
    assert core.digest() == hashlib.blake2b(data, digest_size=64).digest()


def test_set_state_continues_the_stream():
    """A transcript moved to the explicit core by `set_state` continues
    byte-identically, as one handed back by a device transcript must."""
    a, b = Blake2b512Rng.setup(), Blake2b512Rng.setup()
    for rng in (a, b):
        rng.feed(b"prefix" * 30)
        rng.fill_bytes(70)
    b.set_state(*b.state_tuple())
    for rng in (a, b):
        rng.feed(serialize_u8_vec(b"more"))
    assert a.fill_bytes(100) == b.fill_bytes(100)
    assert Fr.rand(a) == Fr.rand(b)


def test_matches_jax_transcript():
    vals = [Fr(v) for v in (0, 1, 12345, (1 << 254) + 7)]
    a, j = Blake2b512Rng.setup(), J.Blake2b512Rng.setup()
    a.feed_bytes(serialize_fr_vec(vals))
    j.feed_bytes(serialize_fr_vec([J.Fr(v.v) for v in vals]))
    for _ in range(5):
        assert Fr.rand(a).v == J.Fr.rand(j).v
    assert a.next_u32() == j.next_u32()
    assert a.fill_bytes(64) == j.fill_bytes(64)
