"""Theoretical bounds from the paper -- the port's counterpart of
``repro/core/bounds.py``, as plain tensor ops.

* ``lml_bound`` -- Theorem 1 (List Matching Lemma), eq. (3).
* ``lml_conditional_bound`` -- Theorem 1 eq. (4): Pr[accept | Y=j].
* ``lml_relaxed_bound`` -- the relaxed form  sum_j q_j (1 + q_j/(K p_j))^-1
  derived at the end of App. A.2.
* ``conditional_lml_bound`` -- Theorem 2 (compression setting).
* ``tv_distance`` / ``maximal_coupling_acceptance`` -- classical 1 - d_TV.
* ``single_draft_gumbel_bound`` -- Daliri et al. (1-TV)/(1+TV).
* ``iid_draft_acceptance_upper`` -- sum_j min(q_j, 1-(1-p_j)^K), the
  optimal with-communication upper bound for K i.i.d. drafts.
* ``wz_error_upper_bound`` -- Proposition 4 (Wyner-Ziv error).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "tv_distance",
    "maximal_coupling_acceptance",
    "single_draft_gumbel_bound",
    "lml_bound",
    "lml_conditional_bound",
    "lml_relaxed_bound",
    "conditional_lml_bound",
    "iid_draft_acceptance_upper",
    "wz_error_upper_bound",
]

_TINY = float(np.finfo(np.float32).tiny)


def tv_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Total variation distance between two discrete distributions."""
    return 0.5 * torch.sum(torch.abs(p - q), dim=-1)


def maximal_coupling_acceptance(p: torch.Tensor,
                                q: torch.Tensor) -> torch.Tensor:
    """Optimal single-sample matching probability WITH communication."""
    return 1.0 - tv_distance(p, q)


def single_draft_gumbel_bound(p: torch.Tensor,
                              q: torch.Tensor) -> torch.Tensor:
    """Daliri et al. communication-free bound: (1-TV)/(1+TV)."""
    tv = tv_distance(p, q)
    return (1.0 - tv) / (1.0 + tv)


def _ratio_grid(v: torch.Tensor) -> torch.Tensor:
    """r[i, j] = v_i / v_j, dividing by 1 where v_j == 0 (the caller
    masks those columns)."""
    den = v[None, :]
    return v[:, None] / torch.where(den > 0, den, torch.ones_like(den))


def lml_bound(p: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """Theorem 1 eq. (3):

    Pr[Y in {X}] >= sum_j K / sum_i [max(q_i/q_j, p_i/p_j) + (K-1) q_i/q_j].

    Terms with q_j == 0 contribute nothing; p_j == 0 drives p_i/p_j to
    +inf for every p_i > 0, and so the j-th summand to 0."""
    inf = torch.full((), float("inf"), dtype=p.dtype, device=p.device)
    qr = _ratio_grid(q)
    pr = _ratio_grid(p)
    pr = torch.where((p <= 0)[None, :] & (p[:, None] > 0), inf, pr)
    qr = torch.where((q <= 0)[None, :] & (q[:, None] > 0), inf, qr)
    denom = torch.sum(torch.maximum(qr, pr) + (k - 1) * qr, dim=0)
    summand = k / denom
    return torch.sum(torch.where(q > 0, summand, torch.zeros_like(summand)))


def lml_conditional_bound(p_j: torch.Tensor, q_j: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Theorem 1 eq. (4): Pr[accept | Y=j] >= (1 + q_j/(K p_j))^-1."""
    return 1.0 / (1.0 + q_j / (k * torch.clamp(p_j, min=_TINY)))


def lml_relaxed_bound(p: torch.Tensor, q: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Relaxed LML (end of App. A.2):  sum_j q_j (1 + q_j/(K p_j))^-1."""
    terms = q * lml_conditional_bound(p, q, k)
    return torch.sum(torch.where((q > 0) & (p > 0), terms,
                                 torch.zeros_like(terms)))


def conditional_lml_bound(q_j_a: torch.Tensor, p_j_zk: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Theorem 2:  Pr[match | Y=j, A=a, Z^K] >= sum_k (K + q_j(a)/p_j(z_k))^-1.

    q_j_a: scalar -- the encoder target prob of the selected index;
    p_j_zk: (K,) -- each decoder's target prob of that index."""
    return torch.sum(1.0 / (k + q_j_a / torch.clamp(p_j_zk, min=_TINY)))


def iid_draft_acceptance_upper(p: torch.Tensor, q: torch.Tensor,
                               k: int) -> torch.Tensor:
    """Pr[Y in list] <= sum_j min(q_j, 1 - (1-p_j)^K) for ANY scheme with
    K i.i.d. drafts (the list holds j with probability 1-(1-p_j)^K)."""
    return torch.sum(torch.minimum(q, 1.0 - (1.0 - p) ** k))


def wz_error_upper_bound(info_density: torch.Tensor, k: int,
                         l_max: int) -> torch.Tensor:
    """Proposition 4: Pr[err] <= 1 - E[(1 + 2^{i(W;A|T)} / (K L_max))^-1].

    info_density: samples of i(W;A|T) in bits (log2), any shape."""
    inner = 1.0 / (1.0 + torch.exp2(info_density) / (k * l_max))
    return 1.0 - torch.mean(inner)
