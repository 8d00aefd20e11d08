"""Error types, mirroring the reference's error split (SURVEY.md §5):

- Python exceptions (`SumcheckError` subclasses other than `Reject`) for API
  misuse — the reference's panics (`prover.rs:51,80,91,97`,
  `verifier.rs:60,95,100,105`).
- `Reject` for soundness failure — the reference's `Error::Reject`
  (`src/error.rs:7-18`, raised at `verifier.rs:110-113`).
"""

from __future__ import annotations


class SumcheckError(Exception):
    """Base error for the framework (reference `src/error.rs` `Error`)."""


class Reject(SumcheckError):
    """The protocol rejects this proof (soundness failure)."""

    def __init__(self, msg: str | None = None):
        super().__init__(msg or "proof rejected")


class SerializationError(SumcheckError):
    pass


class IOError_(SumcheckError):
    """Reference `Error::IOError` (`error.rs:10`): wraps I/O failures via a
    `From` impl. The reference never constructs it in-crate; provided for
    API-surface parity (callers composing larger protocols can reuse the
    framework's error base the way `ark-sumcheck` users reuse `Error`)."""


class RNGError(SumcheckError):
    """Reference `Error::RNGError` (`error.rs:14`): randomness-source
    failure. Never raised by the reference itself; parity surface only."""


class OtherError(SumcheckError):
    """Reference `Error::OtherError(String)` (`error.rs:17`): free-form
    error carrier for downstream protocol layers."""

    def __init__(self, msg: str):
        super().__init__(msg)
