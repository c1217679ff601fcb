"""Race-family token verification on shared uniforms -- the port's
counterpart of ``repro/specdec/verify.py`` (``gumbel_race_argmin``,
``draft_token_from_uniforms`` and the race-family step verifiers
``gls_verify``, ``gls_verify_strong``, ``daliri_verify``).

The rejection-sampling verifiers (SpecInfer, SpecTr, Leviathan) are a
later slice (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_TINY = 1e-30


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
