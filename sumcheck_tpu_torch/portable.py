"""Portable field-generic engine: MLSumcheck + GKR round sumcheck over ANY
`fields.generic.Field`, in plain host arithmetic.

This is the per-instance-field path the reference gets for free from its
`F: Field` generic (`src/ml_sumcheck/mod.rs:19`); the port's kernel
wrappers read one field's constants per process, so every *other* field
runs here, on the host, and no kernel serves it. It is also the naive
specification implementation of the protocol — the structures and round
math follow the reference line-for-line semantics
(`protocol/prover.rs:74-153`, `protocol/verifier.rs:90-121`,
`gkr_round_sumcheck/mod.rs:22-139`) with none of the limb/digit machinery —
which makes it a differential-testing oracle against the host engine and
the kernels (over the default field, proof bytes must match exactly).
Copied from `sumcheck_tpu/portable.py`.

Performance note: fine for correctness-scale instances (nv <= ~14); the
production path for a hot field is to make it the process default
(``SUMCHECK_TPU_FIELD``) so the kernels serve it.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .fields.generic import Field, FieldEl, default_field
from .protocol.prover import ProverMsg
from .utils.errors import Reject, SumcheckError


def _as_el(f: Field, x):
    if isinstance(x, FieldEl):
        assert x.f is f, "element of a different field"
        return x
    return f.el(int(x) if not hasattr(x, "v") else x.v)


class PortableDenseMLE:
    """Dense MLE over an arbitrary field: evaluation list, natural index
    order (`ark_poly::DenseMultilinearExtension` surface, SURVEY.md L0)."""

    __slots__ = ("field", "num_vars", "evals")

    def __init__(self, field: Field, num_vars: int, evals: list):
        assert len(evals) == 1 << num_vars
        self.field = field
        self.num_vars = num_vars
        self.evals = evals

    @staticmethod
    def from_evaluations(field: Field, num_vars: int, values: Iterable):
        return PortableDenseMLE(
            field, num_vars, [_as_el(field, v) for v in values]
        )

    @staticmethod
    def rand(field: Field, num_vars: int, rng) -> "PortableDenseMLE":
        """rng: `random.Random`-like."""
        return PortableDenseMLE(
            field, num_vars,
            [field.el(rng.randrange(field.P)) for _ in range(1 << num_vars)],
        )

    @staticmethod
    def zero(field: Field, num_vars: int = 0) -> "PortableDenseMLE":
        return PortableDenseMLE(
            field, num_vars, [field.zero()] * (1 << num_vars)
        )

    def __len__(self) -> int:
        return 1 << self.num_vars

    def __getitem__(self, i: int):
        return self.evals[i]

    def fix_variables(self, partial_point: Sequence) -> "PortableDenseMLE":
        """Fold the first variables (low index bits), reference
        `fix_variables` semantics: new[b] = old[2b] + r*(old[2b+1]-old[2b])."""
        ev = self.evals
        k = len(partial_point)
        assert k <= self.num_vars
        for r in partial_point:
            r = _as_el(self.field, r)
            ev = [
                ev[2 * b] + r * (ev[2 * b + 1] - ev[2 * b])
                for b in range(len(ev) // 2)
            ]
        return PortableDenseMLE(self.field, self.num_vars - k, ev)

    def evaluate(self, point: Sequence):
        assert len(point) == self.num_vars
        return self.fix_variables(point).evals[0]

    def scaled_add(self, coeff, other: "PortableDenseMLE") -> "PortableDenseMLE":
        """self + coeff*other (`gkr_round_sumcheck/mod.rs:72-74` pattern)."""
        if self.num_vars == 0 and len(self.evals) == 1 and self.evals[0].is_zero():
            base = [self.field.zero()] * (1 << other.num_vars)
            nv = other.num_vars
        else:
            assert self.num_vars == other.num_vars
            base, nv = self.evals, self.num_vars
        c = _as_el(self.field, coeff)
        return PortableDenseMLE(
            self.field, nv, [a + c * b for a, b in zip(base, other.evals)]
        )


class PortableSparseMLE:
    """Sparse MLE over an arbitrary field (`SparseMultilinearExtension`
    surface as consumed by GKR, `gkr_round_sumcheck/mod.rs:22-42`)."""

    __slots__ = ("field", "num_vars", "entries")

    def __init__(self, field: Field, num_vars: int, entries: dict):
        self.field = field
        self.num_vars = num_vars
        self.entries = dict(sorted(entries.items()))

    @staticmethod
    def rand_with_config(field: Field, num_vars: int, num_nonzero: int, rng):
        seen: dict = {}
        while len(seen) < num_nonzero:
            seen[rng.randrange(1 << num_vars)] = field.el(rng.randrange(field.P))
        return PortableSparseMLE(field, num_vars, seen)

    @property
    def num_nonzero(self) -> int:
        return len(self.entries)

    def fix_variables(self, partial_point: Sequence) -> "PortableSparseMLE":
        k = len(partial_point)
        assert k <= self.num_vars
        rs = [_as_el(self.field, r) for r in partial_point]
        one = self.field.one()
        out: dict = {}
        for idx, v in self.entries.items():
            w = v
            for i, r in enumerate(rs):
                w = w * (r if (idx >> i) & 1 else one - r)
            key = idx >> k
            out[key] = out.get(key, self.field.zero()) + w
        return PortableSparseMLE(self.field, self.num_vars - k, out)

    def to_dense(self) -> PortableDenseMLE:
        ev = [self.field.zero()] * (1 << self.num_vars)
        for idx, v in self.entries.items():
            ev[idx] = v
        return PortableDenseMLE(self.field, self.num_vars, ev)

    def evaluate(self, point: Sequence):
        assert len(point) == self.num_vars
        fixed = self.fix_variables(point)
        return fixed.entries.get(0, self.field.zero())


class PortableProverState:
    """Reference `ProverState` shape (`prover.rs:19-33`)."""

    def __init__(self, field, randomness, list_of_products, flattened, nv, deg):
        self.field = field
        self.randomness = randomness
        self.list_of_products = list_of_products
        self.flattened_ml_extensions = flattened
        self.num_vars = nv
        self.max_multiplicands = deg
        self.round = 0


def prover_init(polynomial) -> PortableProverState:
    """`IPForMLSumcheck::prover_init` (`prover.rs:49-69`) over the portable
    structures; deep-copies each unique table."""
    if polynomial.num_variables == 0:
        raise SumcheckError("Attempt to prove a constant.")
    field = polynomial.field
    flattened = [
        PortableDenseMLE(field, m.num_vars, list(m.evals))
        for m in polynomial.flattened_ml_extensions
    ]
    return PortableProverState(
        field, [], [(c, list(ix)) for c, ix in polynomial.products],
        flattened, polynomial.num_variables, polynomial.max_multiplicands,
    )


def prove_round(state: PortableProverState, v_msg) -> ProverMsg:
    """`IPForMLSumcheck::prove_round` (`prover.rs:74-153`): fold by the
    previous challenge, then the start/step arithmetic-progression ladder."""
    if v_msg is not None:
        if state.round == 0:
            raise SumcheckError("first round should be prover first")
        r = _as_el(state.field, v_msg.randomness)
        state.randomness.append(r)
        state.flattened_ml_extensions = [
            m.fix_variables([r]) for m in state.flattened_ml_extensions
        ]
    elif state.round > 0:
        raise SumcheckError("verifier message is empty")
    state.round += 1
    if state.round > state.num_vars:
        raise SumcheckError("prover is not active")
    i, nv, deg = state.round, state.num_vars, state.max_multiplicands
    field = state.field
    sums = [field.zero()] * (deg + 1)
    tabs = state.flattened_ml_extensions
    for b in range(1 << (nv - i)):
        for coeff, ix in state.list_of_products:
            c = _as_el(field, coeff)
            prod = [c] * (deg + 1)
            for j in ix:
                start = tabs[j].evals[b << 1]
                step = tabs[j].evals[(b << 1) + 1] - start
                cur = start
                for t in range(deg + 1):
                    prod[t] = prod[t] * cur
                    cur = cur + step
            for t in range(deg + 1):
                sums[t] = sums[t] + prod[t]
    return ProverMsg(sums)


class _VMsg:
    __slots__ = ("randomness",)

    def __init__(self, randomness):
        self.randomness = randomness


def _interpolate(field: Field, p_vals: list, eval_at) -> FieldEl:
    """`interpolate_uni_poly` (`verifier.rs:139-251`) over any field:
    inversion-free Lagrange form (prefix/suffix numerators, constant
    denominators)."""
    p = field.P
    n = len(p_vals)
    r = eval_at.v
    if r < n:
        return p_vals[r]
    facs = [(r - j) % p for j in range(n)]
    suf = [1] * n
    for i in range(n - 2, -1, -1):
        suf[i] = suf[i + 1] * facs[i + 1] % p
    fact = [1]
    for i in range(1, n):
        fact.append(fact[-1] * i % p)
    acc, pre = 0, 1
    for i in range(n):
        c = pow(fact[i] * fact[n - 1 - i] * (p - 1) ** ((n - 1 - i) & 1), -1, p)
        acc = (acc + p_vals[i].v * c % p * pre * suf[i]) % p
        pre = pre * facs[i] % p
    return field.el(acc)


def verify_rounds(field: Field, msgs: list[ProverMsg], randomness: list,
                  asserted_sum, max_multiplicands: int):
    """The deferred check loop (`verifier.rs:90-121`) over any field."""
    expected = _as_el(field, asserted_sum)
    for ev, r in zip(msgs, randomness):
        evaluations = ev.evaluations
        if len(evaluations) != max_multiplicands + 1:
            raise SumcheckError("incorrect number of evaluations")
        if evaluations[0] + evaluations[1] != expected:
            raise Reject("Prover message is not consistent with the claim.")
        expected = _interpolate(field, evaluations, r)
    return expected


def prove_as_subprotocol(fs_rng, polynomial):
    """Portable `MLSumcheck::prove_as_subprotocol` (`ml_sumcheck/mod.rs:50-70`)
    — identical transcript schedule, any field."""
    fs_rng.feed(polynomial.info())
    state = prover_init(polynomial)
    v_msg = None
    msgs = []
    for _ in range(polynomial.num_variables):
        pm = prove_round(state, v_msg)
        fs_rng.feed(pm)
        msgs.append(pm)
        v_msg = _VMsg(polynomial.field.rand(fs_rng))
    state.randomness.append(v_msg.randomness)
    return msgs, state


def verify_as_subprotocol(fs_rng, field: Field, polynomial_info, claimed_sum,
                          proof):
    """Portable `MLSumcheck::verify_as_subprotocol` (`mod.rs:84-100`)."""
    from .protocol.verifier import SubClaim

    fs_rng.feed(polynomial_info)
    randomness = []
    for i in range(polynomial_info.num_variables):
        if i >= len(proof):
            raise IndexError("proof is incomplete")
        fs_rng.feed(proof[i])
        randomness.append(field.rand(fs_rng))
    expected = verify_rounds(
        field, proof, randomness, claimed_sum,
        polynomial_info.max_multiplicands,
    )
    return SubClaim(randomness, expected)


# --------------------------------------------------------------------------
# GKR round sumcheck, portable (reference `gkr_round_sumcheck/mod.rs`)
# --------------------------------------------------------------------------


def gkr_prove(rng, f1: PortableSparseMLE, f2: PortableDenseMLE,
              f3: PortableDenseMLE, g: Sequence):
    """`GKRRoundSumcheck::prove` (`mod.rs:93-139`) over any field."""
    from .gkr_round_sumcheck import GKRProof

    field = f2.field
    assert f1.num_vars == 3 * f2.num_vars == 3 * f3.num_vars
    dim = f2.num_vars
    g = [_as_el(field, x) for x in g]

    # phase 1 init (`mod.rs:22-42`): h_g(x) = sum_y f1(g,x,y) * f3(y)
    f1_g = f1.fix_variables(g)
    hg = [field.zero()] * (1 << dim)
    mask = (1 << dim) - 1
    for xy, v in f1_g.entries.items():
        hg[xy & mask] = hg[xy & mask] + v * f3.evals[xy >> dim]
    h_g = PortableDenseMLE(field, dim, hg)

    poly1 = PortableListOfProducts(dim, field)
    poly1.add_product([h_g, f2], field.one())
    st1 = prover_init(poly1)
    vm = None
    msgs1, u = [], []
    for _ in range(dim):
        pm = prove_round(st1, vm)
        rng.feed(pm)
        msgs1.append(pm)
        vm = _VMsg(field.rand(rng))
        u.append(vm.randomness)

    f1_gu = f1_g.fix_variables(u).to_dense()
    f3_f2u = PortableDenseMLE.zero(field).scaled_add(f2.evaluate(u), f3)
    poly2 = PortableListOfProducts(dim, field)
    poly2.add_product([f1_gu, f3_f2u], field.one())
    st2 = prover_init(poly2)
    vm = None
    msgs2 = []
    for _ in range(dim):
        pm = prove_round(st2, vm)
        rng.feed(pm)
        msgs2.append(pm)
        vm = _VMsg(field.rand(rng))
    return GKRProof(msgs1, msgs2)


def gkr_verify(rng, field: Field, f2_num_vars: int, proof, claimed_sum):
    """`GKRRoundSumcheck::verify` (`mod.rs:147-192`) over any field."""
    from .gkr_round_sumcheck import GKRRoundSumcheckSubClaim

    dim = f2_num_vars
    u = []
    for pm in proof.phase1_sumcheck_msgs:
        rng.feed(pm)
        u.append(field.rand(rng))
    e1 = verify_rounds(field, proof.phase1_sumcheck_msgs, u, claimed_sum, 2)
    v = []
    for pm in proof.phase2_sumcheck_msgs:
        rng.feed(pm)
        v.append(field.rand(rng))
    e2 = verify_rounds(field, proof.phase2_sumcheck_msgs, v, e1, 2)
    return GKRRoundSumcheckSubClaim(u=u, v=v, expected_evaluation=e2)


class PortableListOfProducts:
    """Field-carrying `ListOfProductsOfPolynomials`
    (`data_structures.rs:24-109` incl. the `Rc`-identity dedup)."""

    def __init__(self, num_variables: int, field: Field | None = None):
        self.field = field if field is not None else default_field()
        self.max_multiplicands = 0
        self.num_variables = num_variables
        self.products: list = []
        self.flattened_ml_extensions: list[PortableDenseMLE] = []
        self._id_lookup: dict[int, int] = {}

    def add_product(self, product: Iterable[PortableDenseMLE], coefficient):
        coefficient = _as_el(self.field, coefficient)
        product = list(product)
        assert product, "product must not be empty"
        self.max_multiplicands = max(self.max_multiplicands, len(product))
        indexed = []
        for m in product:
            assert m.num_vars == self.num_variables
            assert m.field is self.field, "multiplicand from a different field"
            key = id(m)
            if key not in self._id_lookup:
                self._id_lookup[key] = len(self.flattened_ml_extensions)
                self.flattened_ml_extensions.append(m)
            indexed.append(self._id_lookup[key])
        self.products.append((coefficient, indexed))

    def info(self):
        from .data_structures import PolynomialInfo

        return PolynomialInfo(self.max_multiplicands, self.num_variables)

    def evaluate(self, point: Sequence):
        evals = [m.evaluate(point) for m in self.flattened_ml_extensions]
        total = self.field.zero()
        for coeff, indices in self.products:
            term = coeff
            for i in indices:
                term = term * evals[i]
            total = total + term
        return total
