"""The system under test: the port's batched provers, reached through their
public entry points only.

`ml`: `BatchedMLSumcheck.prove_as_subprotocol` over B polynomials of the
pool, each call with B fresh `Blake2b512Rng` transcripts fed their
labels. `gkr`: `BatchedGKRRoundSumcheck.prove` over the pool's B
instances, which share one wiring f1, each call with B fresh transcripts
and B fresh points g.

Each call returns, per instance, what the check judges: the proof's
bytes in the port's arkworks encoding, the challenges where the entry
point returns them, and the transcript, whose next field element stands
for its final state.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

UPLOAD_THREADS = 8


class Program:
    def __init__(self, config: dict, pool, device):
        import sumcheck_tpu_torch as T

        self.T = T
        self.protocol = config["protocol"]
        self.device = device
        if self.protocol == "ml":
            nv = config["num_variables"]
            self.polys = []
            for tables, coeffs in zip(pool.tables, pool.coeffs):
                mles = [T.DenseMLE(nv, t) for t in tables]
                poly = T.ListOfProductsOfPolynomials(nv)
                for ix, c in zip(config["products"], coeffs):
                    poly.add_product([mles[i] for i in ix], T.Fr(c))
                self.polys.append(poly)
            self.mles = [m for poly in self.polys for m in poly.flattened_ml_extensions]
        else:
            dim = config["dim"]
            # one SparseMLE for the batch: its split is made once and cached on it
            self.f1 = [T.SparseMLE(3 * dim, *pool.f1)] * len(pool.f2)
            self.f2 = [T.DenseMLE(dim, t) for t in pool.f2]
            self.f3 = [T.DenseMLE(dim, t) for t in pool.f3]
            self.mles = self.f2 + self.f3

    def upload(self) -> None:
        """Every dense table to the device (`DenseMLE.to_device`), where the
        prover keeps them between calls, several at once."""
        with ThreadPoolExecutor(UPLOAD_THREADS) as ex:
            for fut in [ex.submit(m.to_device, self.device) for m in self.mles]:
                fut.result()

    def prepare(self, inputs: dict) -> tuple:
        """The caller's side of a call, before it is timed: its transcripts,
        each fed its label, and its points."""
        rngs = []
        for label in inputs["labels"]:
            rng = self.T.Blake2b512Rng.setup()
            rng.feed(label)
            rngs.append(rng)
        if self.protocol == "ml":
            return (rngs,)
        return rngs, [[self.T.Fr(v) for v in g] for g in inputs["g"]]

    def call(self, args: tuple) -> list:
        """One batched prove; returns one record an instance."""
        from sumcheck_tpu_torch.batch import BatchedGKRRoundSumcheck, BatchedMLSumcheck

        if self.protocol == "ml":
            (rngs,) = args
            proofs, challenges = BatchedMLSumcheck.prove_as_subprotocol(
                rngs, self.polys, device=self.device)
            return [{"proof": p, "challenges": c, "rng": r}
                    for p, c, r in zip(proofs, challenges, rngs)]
        rngs, gs = args
        proofs = BatchedGKRRoundSumcheck.prove(rngs, self.f1, self.f2, self.f3, gs,
                                               device=self.device)
        return [{"proof": p, "challenges": None, "rng": r} for p, r in zip(proofs, rngs)]

    def judge(self, record: dict) -> dict:
        """What the check compares of one instance's output."""
        from sumcheck_tpu_torch.ml_sumcheck import serialize_proof

        proof = record["proof"]
        data = (serialize_proof(proof) if self.protocol == "ml"
                else proof.serialize_uncompressed())
        chal = None if record["challenges"] is None else [r.v for r in record["challenges"]]
        return {"bytes": data, "challenges": chal, "next": self.T.Fr.rand(record["rng"]).v}
