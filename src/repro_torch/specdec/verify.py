"""Token-level verification for multi-draft speculative decoding -- the
port's counterpart of ``repro/specdec/verify.py``: ``gumbel_race_argmin``,
``draft_token_from_uniforms``, the race-family step verifiers on shared
uniforms (``gls_verify``, ``gls_verify_strong``, ``daliri_verify``) and
the rejection-sampling ones on explicit keys (``specinfer_verify``,
``spectr_verify``, ``single_draft_verify``).

Each verifier handles ONE decoding step.  The rejection-sampling ones
also take leading batch axes (one key per batch element), which is how
``block_verify`` runs R requests at once; per element they draw what
``jax.vmap`` of JAX's verifier draws.  Their randomness is split off
first (``rs_randomness``: the uniforms of the K accept tests and the
Gumbel noise of the residual draw) so a block can draw all its steps'
noise in one pass; the cores then run on the device with no host
sync.  Constants are float32, as JAX forms its Python floats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R

_TINY = 1e-30
_F32_TINY = float(np.float32(_TINY))


class StepResult(NamedTuple):
    token: torch.Tensor        # int64 -- the step's output token
    accepted: torch.Tensor     # bool -- True if it came from some draft
    new_active: torch.Tensor   # (K,) bool -- drafts still viable


def _inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("inf"), dtype=x.dtype, device=x.device)


def race_scores(log_u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """``log(-log U) - log p`` with zero-probability symbols at +inf."""
    log_s = torch.log(-log_u)
    score = log_s - torch.log(torch.clamp(probs, min=_TINY))
    return torch.where(probs > 0, score, _inf_like(score))


def gumbel_race_argmin(log_u: torch.Tensor, probs: torch.Tensor
                       ) -> torch.Tensor:
    """argmin_i -ln(U_i) / p_i over the last axis, in log space; ties go
    to the lower index (``torch.argmin`` returns the first minimum)."""
    return torch.argmin(race_scores(log_u, probs), dim=-1)


def draft_token_from_uniforms(log_u: torch.Tensor, draft_probs: torch.Tensor
                              ) -> torch.Tensor:
    """Gumbel-max draft sampling from the SAME uniforms used at verify."""
    return gumbel_race_argmin(log_u, draft_probs)


def _flat_race(score: torch.Tensor, draft_tokens, active) -> StepResult:
    flat = torch.argmin(score.reshape(-1))
    token = flat % score.shape[1]
    new_active = active & (draft_tokens == token)
    return StepResult(token=token, accepted=new_active.any(),
                      new_active=new_active)


def gls_verify(log_u, draft_tokens, target_probs, active) -> StepResult:
    """Algorithm 2, one step: log_u/target_probs (K, N); the race runs
    over the ACTIVE drafts' rows."""
    score = race_scores(log_u, target_probs)
    score = torch.where(active[:, None], score, _inf_like(score))
    return _flat_race(score, draft_tokens, active)


def gls_verify_strong(log_u, draft_tokens, target_probs, active
                      ) -> StepResult:
    """App. B: the race runs over ALL K drafts' rows."""
    return _flat_race(race_scores(log_u, target_probs), draft_tokens, active)


def daliri_verify(log_u, draft_token, target_probs) -> StepResult:
    """Daliri et al. single-draft Gumbel coupling (K = 1 GLS)."""
    token = gumbel_race_argmin(log_u, target_probs)
    ok = token == draft_token
    return StepResult(token=token, accepted=ok, new_active=ok[None])


# ---------------------------------------------------------------------------
# Rejection-sampling family (SpecInfer, SpecTr, Leviathan)
# ---------------------------------------------------------------------------


def rs_randomness(key: torch.Tensor, num_tests: int, vocab: int):
    """One step's noise: key (..., 2) -> (u (..., num_tests), g (...,
    vocab)).  ``split(key, num_tests + 1)``: key i < num_tests draws the
    i-th accept test's scalar ``uniform``, the last key the Gumbel noise
    of the residual's ``categorical`` (``verify.py:114,121,137``; for
    single, num_tests = 1 is ``split(key)``, ``verify.py:201``)."""
    keys = R.split(key, num_tests + 1)
    return (R.uniform(keys[..., :num_tests, :], ()),
            R.gumbel(keys[..., num_tests, :], (vocab,)))


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per batch element: x (..., N), idx (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _normalized(resid: torch.Tensor, fallback: torch.Tensor):
    """resid / sum(resid), or ``fallback`` where the sum is <= tiny."""
    rsum = resid.sum(-1, keepdim=True)
    return torch.where(rsum > _F32_TINY, resid / rsum, fallback)


def _draw_residual(g: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    """``categorical(key, log(max(resid, tiny)))`` on the noise g."""
    return torch.argmax(g + torch.log(torch.clamp(resid, min=_F32_TINY)),
                        dim=-1)


def specinfer_core(u, g, draft_probs, draft_tokens, target_probs, active
                   ) -> StepResult:
    """SpecInfer on drawn noise (``verify.py:101-144``): try the drafts in
    order with u < q(x)/p(x); a draft tried and rejected moves the
    residual q <- norm(max(q - p, 0)).  u (..., K), g (..., N),
    draft_probs/target_probs (..., K, N), draft_tokens/active (..., K)."""
    k = draft_probs.shape[-2]
    q = target_probs[..., 0, :]
    done = torch.zeros_like(active[..., 0])
    token = torch.zeros_like(draft_tokens[..., 0])
    for idx in range(k):
        x = draft_tokens[..., idx]
        p_idx = draft_probs[..., idx, :]
        px = torch.clamp(_at(p_idx, x), min=_F32_TINY)
        ok = active[..., idx] & (u[..., idx] < _at(q, x) / px) & ~done
        token = torch.where(ok, x, token)
        done = done | ok
        # Only a draft tried and rejected updates the residual (``tried``
        # reads ``done`` after it absorbed ``ok``).
        tried = active[..., idx] & ~done
        resid = _normalized(torch.clamp(q - p_idx, min=0.0), q)
        q = torch.where(tried[..., None], resid, q)
    token = torch.where(done, token, _draw_residual(g, q))
    new_active = active & (draft_tokens == token[..., None]) & done[..., None]
    return StepResult(token=token, accepted=done, new_active=new_active)


def spectr_core(u, g, draft_probs, draft_tokens, target_probs, active
                ) -> StepResult:
    """SpecTr K-SEQ on drawn noise (``verify.py:147-194``): accept X_i
    with probability b(X_i) = min(1, q / (J p)) over the J active drafts,
    else draw the deflated residual q - p b (1 - (1 - abar)^J) / abar."""
    k = draft_probs.shape[-2]
    p = draft_probs[..., 0, :]
    q = target_probs[..., 0, :]
    j_act = torch.clamp(active.to(torch.float32).sum(-1), min=1.0)
    b = torch.clamp(q / torch.clamp(j_act[..., None] * p, min=_F32_TINY),
                    max=1.0)
    b = torch.where(p > 0, b, torch.zeros((), dtype=b.dtype,
                                          device=b.device))
    abar = (p * b).sum(-1)
    done = torch.zeros_like(active[..., 0])
    token = torch.zeros_like(draft_tokens[..., 0])
    for idx in range(k):
        x = draft_tokens[..., idx]
        ok = active[..., idx] & (u[..., idx] < _at(b, x)) & ~done
        token = torch.where(ok, x, token)
        done = done | ok
    scale = torch.where(
        abar > _F32_TINY,
        (1.0 - (1.0 - abar) ** j_act) / torch.clamp(abar, min=_F32_TINY),
        j_act)
    resid = _normalized(torch.clamp(q - p * b * scale[..., None], min=0.0),
                        q)
    token = torch.where(done, token, _draw_residual(g, resid))
    new_active = active & (draft_tokens == token[..., None]) & done[..., None]
    return StepResult(token=token, accepted=done, new_active=new_active)


def single_draft_core(u, g, draft_probs, draft_token, target_probs
                      ) -> StepResult:
    """Leviathan et al. on drawn noise (``verify.py:197-212``): accept
    w.p. min(1, q(x)/p(x)), else draw norm(max(q - p, 0)).  u (..., 1),
    g and the probabilities (..., N), draft_token (...)."""
    x = draft_token
    px = torch.clamp(_at(draft_probs, x), min=_F32_TINY)
    ok = u[..., 0] < torch.clamp(_at(target_probs, x) / px, max=1.0)
    resid = _normalized(torch.clamp(target_probs - draft_probs, min=0.0),
                        target_probs)
    token = torch.where(ok, x, _draw_residual(g, resid))
    return StepResult(token=token, accepted=ok, new_active=ok[..., None])


def specinfer_verify(key, draft_probs, draft_tokens, target_probs, active
                     ) -> StepResult:
    """SpecInfer recursive rejection sampling, one step
    (``verify.py:101``): key (..., 2), draft_probs/target_probs (..., K,
    N), draft_tokens/active (..., K)."""
    k, n = draft_probs.shape[-2:]
    return specinfer_core(*rs_randomness(key, k, n), draft_probs,
                          draft_tokens, target_probs, active)


def spectr_verify(key, draft_probs, draft_tokens, target_probs, active
                  ) -> StepResult:
    """SpecTr k-sequential verification, one step (``verify.py:147``)."""
    k, n = draft_probs.shape[-2:]
    return spectr_core(*rs_randomness(key, k, n), draft_probs, draft_tokens,
                       target_probs, active)


def single_draft_verify(key, draft_probs, draft_token, target_probs
                        ) -> StepResult:
    """Leviathan single-draft rejection sampling, one step
    (``verify.py:197``): key (..., 2), probabilities (..., N)."""
    return single_draft_core(*rs_randomness(key, 1, draft_probs.shape[-1]),
                             draft_probs, draft_token, target_probs)
