"""Structured error/assert layer (reference src/utilities/elagError.hpp).

The reference's macro family becomes typed exceptions + check helpers:

  PARELAG_TEST_FOR_EXCEPTION  -> test_for_exception(cond, Exc, msg)
  PARELAG_ASSERT              -> parelag_assert(cond, msg)  (always on)
  elag_assert                 -> debug_assert(cond, msg)    (gated by
                                 PARELAG_DEBUG=1, the ELAG_DEBUG analog)
  PARELAG_NOT_IMPLEMENTED     -> raise NotImplementedFeature(...)
  hypre error-flag checks     -> n/a (no hypre); solver back-ends raise
                                 SolverFailure with context instead

plus assert_invariants(seq) — DeRhamSequence::CheckInvariants
(DeRhamSequence.cpp:694-970) as a raising check, the self-checking layer
the reference testsuite calls after every Coarsen
(testsuite/coarseSpaces.cpp:186-187).
"""

import os


class ParelagError(RuntimeError):
    """Base of all framework errors (ParELAG_Exceptions.hpp)."""


class InvalidInput(ParelagError, ValueError):
    """Caller passed inconsistent data (PARELAG_TEST_FOR_EXCEPTION with
    std::invalid_argument semantics)."""


class InvariantViolation(ParelagError):
    """A mathematical invariant failed (CheckInvariants family)."""

    def __init__(self, bad, msg=""):
        self.bad = dict(bad)
        detail = ", ".join(f"{k}={v:.3e}" for k, v in self.bad.items())
        super().__init__((msg + ": " if msg else "") + detail)


class NotImplementedFeature(ParelagError, NotImplementedError):
    """PARELAG_NOT_IMPLEMENTED."""


class SolverFailure(ParelagError):
    """A solver failed to converge or factor."""


def test_for_exception(cond, exc_type, msg):
    """Raise exc_type(msg) when cond is truthy (the reference macro raises
    ON the condition, elagError.hpp:114)."""
    if cond:
        raise exc_type(msg)


def parelag_assert(cond, msg="assertion failed"):
    """Always-on check (PARELAG_ASSERT)."""
    if not cond:
        raise ParelagError(msg)


def _debug_enabled():
    return os.environ.get("PARELAG_DEBUG", "0") not in ("", "0", "false")


def debug_assert(cond, msg="debug assertion failed"):
    """Debug-gated check (elag_assert under ELAG_DEBUG,
    elagError.hpp:151-174): only evaluated when PARELAG_DEBUG=1."""
    if _debug_enabled() and not cond:
        raise ParelagError(msg)


def assert_invariants(seq, tol=1e-9, msg="DeRhamSequence invariants"):
    """Run seq.check_invariants and raise InvariantViolation on failures;
    returns the full error dict on success."""
    errs, bad = seq.check_invariants(tol)
    if bad:
        raise InvariantViolation(bad, msg)
    return errs
