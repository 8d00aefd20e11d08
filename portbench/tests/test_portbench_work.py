"""The frozen work counts against counts worked by hand at tiny shapes."""

import pytest

from portbench import work as W


def test_eval_multiplies():
    assert W.eval_multiplies([3, 3], 3) == 14  # (2 + 1) + (3 + 1) a product
    assert W.eval_multiplies([2], 2) == 3
    assert W.eval_multiplies([1], 1) == 0


def test_round_work_by_hand():
    # round 0 over 4 lanes of 6 slots: both halves read, 14 multiplies a lane
    assert W.round_work(4, 6, [3, 3], 3, False) == {"bytes": 2 * 32 * 4 * 6,
                                                     "multiplies": 14 * 4}
    # a fold over 2 lanes: 4 lanes of each half read, 2 of each written
    assert W.round_work(2, 6, [3, 3], 3, True) == {"bytes": 6 * 32 * 2 * 6,
                                                    "multiplies": (14 + 12) * 2}


def test_chain_work_by_hand():
    # nv = 3, one product of 2: round 0 over 4 lanes, folds over 2 and 1
    want_bytes = 2 * 32 * 4 * 2 + 6 * 32 * 2 * 2 + 6 * 32 * 1 * 2
    want_mults = 3 * 4 + (3 + 4) * 2 + (3 + 4) * 1
    assert W.chain_work(3, 2, [2], 2) == {"bytes": want_bytes, "multiplies": want_mults}


def test_pair_init_and_gkr_init_by_hand():
    assert W.pair_init_work(2, 6, 6, 2) == {"bytes": 32 * 4 * 12, "multiplies": 8}
    # dim 2, 3 entries: halves 2 + 2 lanes; f1's arrays read once for the batch
    s1, s2 = (4 + 32 + 4 + 4) * 3 + 4 * 4, 4 * 3 + 4 * 4
    p1 = (32 + 32) * 3 + 32 * 4 + 64 * 2 + 64 * 4
    p2 = 32 * 3 + 32 * 4 + 64 * 2 + 64 * 4 + 64 + 64
    m1 = 3 * 3 + 4 + 4 - 2
    m2 = 2 * 3 + 4 + 4 - 2 + 4 + 1
    assert W.gkr_init_work(2, 3) == {"bytes": s1 + s2 + p1 + p2, "multiplies": m1 + m2}
    assert W.gkr_init_work(2, 3, 5) == {"bytes": s1 + s2 + 5 * (p1 + p2),
                                        "multiplies": 5 * (m1 + m2)}


def test_bound_is_the_larger_term():
    # chip_smoke.py's pair-init bound at nv=20, 6 slots: 0.1202 ms of bytes
    assert W.bound_ms(W.pair_init_work(20, 6, 6, 2)) == pytest.approx(0.1202, abs=1e-4)
    # its round-0 bound at 2^19 lanes: 0.1158 ms of multiplies
    assert W.bound_ms(W.round_work(1 << 19, 6, [3, 3], 3, False)) == pytest.approx(
        0.1158, abs=1e-4)


def test_call_work_scales_with_the_batch():
    ml = {"protocol": "ml", "num_variables": 4, "tables": 6, "products": [[0, 1, 2], [3, 4, 5]]}
    one, three = W.call_work(ml, 1), W.call_work(ml, 3)
    assert set(one) == {"pair_init", "round"}
    assert three["round"]["bytes"] == 3 * one["round"]["bytes"]
    gkr = {"protocol": "gkr", "dim": 4, "f1_nonzeros": 16}
    assert set(W.call_work(gkr, 2)) == {"gkr_init", "round"}
