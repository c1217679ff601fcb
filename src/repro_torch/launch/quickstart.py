"""Quickstart of the port: Gumbel-max List Sampling on toy
distributions -- the twin of ``examples/quickstart.py``.

  python -m repro_torch.launch.quickstart [--device cpu]

Coupling one target sample with K i.i.d. proposals through shared
exponential races makes the acceptance probability grow with K, bounded
below by the List Matching Lemma (Thm. 1), while both marginals stay
exact.  The two distributions are Dirichlet draws from JAX's keys
(``random.dirichlet``), the races ``core.gls_sample_batch``; the printed
lines are JAX's example's.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import random as R
from repro_torch.core import (
    gls_sample_batch,
    iid_draft_acceptance_upper,
    lml_bound,
    maximal_coupling_acceptance,
)
from repro_torch.device import resolve_device

KS = (1, 2, 4, 8, 16)


def main(argv=None, log=print) -> dict:
    """Prints the example's table; returns its numbers: ``tv``,
    ``maximal``, ``rows`` (k, empirical, LML bound, upper bound) and
    ``marginal_err``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10, help="alphabet size")
    ap.add_argument("--trials", type=int, default=20_000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    kp, kq, ks = R.split(R.PRNGKey(0), 3)
    n, trials = args.n, args.trials
    p = R.dirichlet(kp, [1.0] * n).to(device)   # Alice's (draft) dist
    q = R.dirichlet(kq, [1.0] * n).to(device)   # Bob's (target) dist
    ks = ks.to(device)

    tv = 0.5 * float((p - q).abs().sum())
    maximal = float(maximal_coupling_acceptance(p, q))
    log(f"alphabet N={n}, TV(p,q)={tv:.3f}")
    log(f"maximal coupling (WITH communication, K=1): {maximal:.3f}\n")
    log(f"{'K':>3} {'empirical':>10} {'LML bound':>10} {'upper bound':>12}")
    rows = []
    for k in KS:
        out = gls_sample_batch(ks, p, q, k, trials)
        # jnp.mean as XLA compiles it: the float32 count times 1/trials.
        acc = float(out.accept.sum().float()
                    * float(np.float32(1.0 / trials)))
        lo = float(lml_bound(p, q, k))
        hi = float(iid_draft_acceptance_upper(p, q, k))
        log(f"{k:>3} {acc:>10.3f} {lo:>10.3f} {hi:>12.3f}")
        assert acc >= lo - 0.01, "LML bound violated!"
        rows.append((k, acc, lo, hi))

    # Marginals stay exact no matter what K is.
    out = gls_sample_batch(ks, p, q, 8, trials)
    y_hist = np.bincount(out.y.cpu().numpy(), minlength=n) / trials
    err = float(np.abs(y_hist - q.cpu().numpy()).max())
    log(f"\nmax |empirical(Y) - q| = {err:.4f}  (exact marginals)")
    return {"tv": tv, "maximal": maximal, "rows": rows, "marginal_err": err}


if __name__ == "__main__":
    main()
