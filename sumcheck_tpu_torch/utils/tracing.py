"""Stage spans of a prove and the one read-out of the port's counters.

`span(stage)` marks one stage of a prove as a `torch.profiler` range named
`sumcheck.<stage>` while a profiler runs, and is a shared null context
otherwise: tracing is on exactly while someone profiles, and with no
profiler the prove takes no record and allocates nothing. The ranges are
the profiler's own host events, on the clock of its device records, kept
and exported by the profiler (`export_chrome_trace`).

A range is an ordinary host op (`_RecordFunctionFast`), not the user
annotation `torch.profiler.record_function` makes: the profiler copies a
user annotation that encloses launches onto the device's timeline as a
device event carrying the host op's correlation id, a number drawn from
the same range as CUDA's, so such copies collide with the launches' ids
and break any join of a device record to its launch by that id.

The stages partition a chained prove, flat (no span opens inside
another): `feed` (checks and the transcripts fed the polynomials' info),
`lift` (the transcripts' upload), `inputs` (a GKR instance's tables and
point on the device), `init` (the table pair, or a GKR phase init), `chain`
(the rounds enqueued), `fetch` (the one device-to-host copy, the prove's
only sync) and `assemble` (proofs, challenges and transcripts built on the
host). Each opens in the helper that does its work, so every chained prove
that reaches the helper carries it.

`counters()` gathers every counter of the port, each an int attribute of
the function that does the counted work, where the tools and tests read it
too.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(stage: str):
    """A profiler range named `sumcheck.<stage>` while a profiler runs, else
    a null context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(f"sumcheck.{stage}")
    return _OFF


def counters() -> dict[str, int]:
    """Every counter of the port, `{"<function>.<attribute>": value}`: each
    kernel wrapper's `.launches` (`ops.launch_counters`), the collectives'
    `.calls`, `.bytes` and `.received` (`parallel/comm.py`), and the batched
    provers' instance counts: `_prove_local.instances` (ML instances proved
    on one device), `_prove_batched_host.instances` (those of them on the
    host-transcript loop), `BatchedGKRRoundSumcheck.prove.instances` (GKR
    instances asked for) and `.alone` (those of them proved one by one)."""
    from .. import batch
    from ..ops import launch_counters
    from ..parallel import comm

    out = {f"{name}.launches": f.launches for name, f in launch_counters().items()}
    for fn, attrs in ((comm.all_reduce_sum_, ("calls", "bytes")),
                      (comm.reduce_scatter_sum_, ("calls", "bytes", "received")),
                      (batch._prove_local, ("instances",)),
                      (batch._prove_batched_host, ("instances",)),
                      (batch._gkr_prove, ("instances", "alone"))):
        for attr in attrs:
            out[f"{fn.__qualname__}.{attr}"] = getattr(fn, attr)
    return out
