"""Typed serving errors and the Wyner-Ziv outcome guard -- the port's own
copy of ``GuardViolation`` and ``validate_wz_batch`` from the JAX
package's ``serving/guard.py`` (its other guards come with the serving
robustness slice).

``GuardViolation`` subclasses ``AssertionError``: an invariant check
and a guard failure are the same class of fault (state corruption seen
before results leave the program), so callers matching
``AssertionError`` keep working.
"""

from __future__ import annotations

import numpy as np


class GuardViolation(AssertionError):
    """A round produced an outcome violating a serving invariant."""

    kind = "guard"
    phase = "post"

    def __init__(self, msg: str, uid=None):
        super().__init__(msg)
        self.uid = uid


def validate_wz_batch(y, message, x, match, ok, *, n_atoms: int,
                      l_max: int, what: str = "wz batch") -> None:
    """Validate a fetched Wyner-Ziv race outcome (host arrays: numpy or
    CPU tensors).  ``ok`` is the pipeline's per-round finite-score flag: a
    NaN- or -inf-poisoned weight row makes every race score non-finite,
    and the argmin then returns index 0 -- in range, so no range check
    can see it; the flag is computed where the scores still exist.

    Checks: every race resolved on a finite score, selections in
    ``[0, n_atoms)``, messages in ``[0, l_max)``, and the match events
    consistent with the selections (``match == (x == y)``).  Raises
    ``GuardViolation``."""
    y, message, x, match, ok = (np.asarray(a) for a in
                                (y, message, x, match, ok))
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise GuardViolation(
            f"{what}: {bad}/{ok.size} rounds resolved on a non-finite "
            "race score (NaN/-inf-poisoned weights reached the race)")
    for name, arr, hi in (("y", y, n_atoms), ("x", x, n_atoms),
                          ("message", message, l_max)):
        if not np.issubdtype(arr.dtype, np.integer):
            raise GuardViolation(
                f"{what}: {name} has non-integer dtype {arr.dtype}")
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= hi):
            raise GuardViolation(
                f"{what}: {name} indices outside [0, {hi}) (range "
                f"[{int(arr.min())}, {int(arr.max())}])")
    if not np.array_equal(match, x == y[:, None]):
        raise GuardViolation(
            f"{what}: match events inconsistent with selections "
            "(corrupted fetch)")
