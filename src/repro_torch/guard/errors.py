"""Typed guard-error taxonomy (the counterpart of :mod:`repro.guard.errors`).

Every validation failure in the guarded-execution subsystem raises a
:class:`GuardError` subclass instead of a bare ``ValueError`` /
``TypeError`` / ``KeyError``, so callers (and the fault-injection
suite) can match on the *corruption class*, not on message text. Each
subclass keeps the backward-compatible builtin base the pre-guard code
raised at the same site — ``pytest.raises(ValueError)`` written against
the old executor still passes:

=================  ==========================  ===========================
error              builtin base                raised when
=================  ==========================  ===========================
NotInvertible      f2.SingularError/ValueError BMMC fails the F2 rank check
ClassMismatch      ValueError                  fast-path plan contradicts
                                               its class predicate
DescriptorOOB      IndexError                  tile/DMA table out of bounds
                                               or semantically wrong
BadInput           ValueError                  shape/dtype/planarity
                                               precondition on a program
                                               input fails
BadStage           TypeError                   non-primitive stage reached
                                               the executor
UnknownEngine      KeyError                    engine-name lookup miss
CachePoisoned      ValueError                  validated plan's fingerprint
                                               changed under the cache
GuardTrap          RuntimeError                runtime guard flags stayed
                                               set after every fallback
=================  ==========================  ===========================
"""
from __future__ import annotations

from ..core import f2


class GuardError(Exception):
    """Base of the validated-execution error taxonomy.

    Never raised directly — every guard failure is one of the typed
    subclasses below, each of which also subclasses the builtin the
    pre-guard code raised at the same site (backward compatibility).
    """


class NotInvertible(GuardError, f2.SingularError):
    """A BMMC matrix failed the plan-time F2 rank check.

    ``f2.SingularError`` is itself a ``ValueError``, so code catching
    either keeps working.
    """


class ClassMismatch(GuardError, ValueError):
    """A plan dispatched as a fast-path class (block / lane / ...) whose
    matrix does not actually satisfy that class predicate — e.g. a
    poisoned class-plan cache handing a general BMMC the block kernel.
    """


class DescriptorOOB(GuardError, IndexError):
    """A tile-plan / DMA descriptor table points outside the array
    geometry, or disagrees with the BMMC it claims to realize (swapped
    entries, truncated tables, out-of-range row ids)."""


class BadInput(GuardError, ValueError):
    """A program input violates a shape / dtype / planarity
    precondition (wrong axis length, non-power-of-2 size, complex input
    to a planar-only path, missing (re, im) trailing dim)."""


class BadStage(GuardError, TypeError):
    """A non-primitive (un-lowered) stage reached the stage executor."""


class UnknownEngine(GuardError, KeyError):
    """Engine-name lookup failed. Subclasses ``KeyError`` so pre-guard
    callers catching that keep working."""


class CachePoisoned(GuardError, ValueError):
    """A plan that passed ring-1 validation no longer matches its
    recorded XOR fingerprint — its cached tables were mutated after
    validation (the cache-poisoning corruption class)."""


class GuardTrap(GuardError, RuntimeError):
    """Runtime guard flags (OOB trap, non-finite sentinel, parity-probe
    mismatch) remained set after the last fallback engine — the request
    fails loudly instead of returning silently-wrong data.

    ``kinds`` names the trap kinds that fired; ``engine`` the last
    engine tried.
    """

    def __init__(self, kinds, engine):
        self.kinds = tuple(kinds)
        self.engine = engine
        super().__init__(
            f"guard trap(s) {sorted(self.kinds)} unrecovered on engine "
            f"{engine!r}; no fallback engine left")
