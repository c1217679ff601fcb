"""Gumbel-max List Sampling (GLS) -- the paper's core contribution
(Sec. 3), the port's counterpart of ``repro/core/gls.py``.

Communication-free coupling between one target sample ``Y ~ q`` and a
list of ``K`` i.i.d. proposal samples ``X^(1..K) ~ p`` built from shared
exponential random numbers ``S_i^(k) = -ln U_i^(k)``:

    X^(k) = argmin_i  S_i^(k) / p_i              (per-draft race)
    Y     = argmin_i  min_k S_i^(k) / q_i        (target races over all K)

Plain tensor ops, as the JAX module is (it does not route through the
race kernels either).  The races run in log space: ``argmin S/p`` is
``argmin log S - log p``; zero-probability symbols get ``-inf`` log-prob
and never win.  A key may carry leading batch axes (one independent draw
per key, as ``jax.vmap`` over keys draws); the distributions broadcast
against them.  Uniform bits equal JAX's; the logs may differ from XLA's
in the last ulp, so a draw can differ only at a float near-tie.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R

__all__ = [
    "exponential_races",
    "gls_sample",
    "gls_sample_heterogeneous",
    "gls_conditional_encoder",
    "gls_conditional_decoder",
    "gls_importance_sample",
    "gls_sample_batch",
    "GLSSample",
]

_TINY = float(np.finfo(np.float32).tiny)


class GLSSample(NamedTuple):
    """Result of one GLS draw: ``y`` the target sample index, ``x`` the
    K proposal sample indices, ``accept`` whether ``y`` is among them."""

    y: torch.Tensor
    x: torch.Tensor
    accept: torch.Tensor


def exponential_races(key: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """K sets of N shared race times in log space, ``log S`` with
    ``S = -log U``, U uniform in [tiny, 1): (..., K, N)."""
    return torch.log(-torch.log(R.uniform(key, (k, n), _TINY, 1.0)))


def _race_argmin(log_s: torch.Tensor, log_p: torch.Tensor) -> torch.Tensor:
    """argmin_i S_i / p_i in log space over the last axis (int32); a NaN
    score (zero probability against a -inf race time) loses."""
    score = log_s - log_p
    score = torch.where(torch.isnan(score),
                        torch.full((), float("inf"), dtype=score.dtype,
                                   device=score.device), score)
    return torch.argmin(score, dim=-1).to(torch.int32)


def _safe_log(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, torch.log(torch.clamp(p, min=_TINY)),
                       torch.full((), float("-inf"), dtype=p.dtype,
                                  device=p.device))


def _sample(log_s, log_p, log_q) -> GLSSample:
    x = _race_argmin(log_s, log_p)                          # (..., K)
    y = _race_argmin(torch.amin(log_s, dim=-2), log_q)      # (...)
    return GLSSample(y=y, x=x, accept=(x == y[..., None]).any(dim=-1))


def gls_sample(key: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
               k: int) -> GLSSample:
    """One GLS draw per key (Algorithm 1): p, q (N,) proposal and target
    distributions, K proposal samples."""
    log_s = exponential_races(key, k, p.shape[-1])
    return _sample(log_s, _safe_log(p)[..., None, :], _safe_log(q))


def gls_sample_heterogeneous(key: torch.Tensor, ps: torch.Tensor,
                             q: torch.Tensor) -> GLSSample:
    """GLS with K different proposal distributions (Prop. 5): ps (K, N),
    q (N,) -- or with the key's batch axes in front of both."""
    kk, n = ps.shape[-2:]
    return _sample(exponential_races(key, kk, n), _safe_log(ps),
                   _safe_log(q))


def gls_conditional_encoder(key: torch.Tensor, q_given_a: torch.Tensor,
                            k: int) -> torch.Tensor:
    """Encoder side (Sec. 5.2): Y = argmin_i min_k S_i^(k) / q_i(a)."""
    log_s = exponential_races(key, k, q_given_a.shape[-1])
    return _race_argmin(torch.amin(log_s, dim=-2), _safe_log(q_given_a))


def gls_conditional_decoder(key: torch.Tensor, p_given_z: torch.Tensor,
                            k: int, which: int) -> torch.Tensor:
    """Decoder ``which`` (0-based): X = argmin_i S_i^(which) / p_i(z)."""
    log_s = exponential_races(key, k, p_given_z.shape[-1])
    return _race_argmin(log_s[..., which, :], _safe_log(p_given_z))


def gls_importance_sample(key: torch.Tensor, log_w_q: torch.Tensor,
                          log_w_p: torch.Tensor, k: int) -> GLSSample:
    """GLS over importance-weighted atoms (App. C): log_w_q (N,) the
    encoder's unnormalised log weights, log_w_p (K, N) the decoders'
    (-inf marks a masked atom).  The race is invariant to the weights'
    normalising constants."""
    log_s = exponential_races(key, k, log_w_q.shape[-1])
    return _sample(log_s, log_w_p, log_w_q)


def gls_sample_batch(key: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                     k: int, batch: int) -> GLSSample:
    """``batch`` independent GLS draws from ``split(key, batch)``."""
    return gls_sample(R.split(key, batch), p, q, k)
