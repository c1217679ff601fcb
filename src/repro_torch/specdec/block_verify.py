"""Device-side block verification (paper Sec. 4, Algorithm 2) for the race
family -- the port's counterpart of ``repro/specdec/block_verify.py``.

For "gls", "gls_strong" and "daliri" the (L+1, K, N) race table of a
block is FIXED (only the (K,) active mask evolves), so it collapses to
per-row (min, argmin) statistics in one batched pass
(``_race_row_stats``) and the L-step loop runs on (L+1, K) scalars
(``_race_block``), with masked ``alive`` propagation instead of early
exit.  Backends: ``"torch"`` (the twin of JAX's "xla": plain tensor
ops) and ``"kernel"`` (the twin of "pallas": the ``gls_row_race`` CUDA
kernel on the card, its plain version on the CPU).  The two compute the
same score floats with the same mask, so their outputs are bit-identical.

``block_verify_batched`` takes a leading request axis R and performs no
host transfer: the fused round packs the result into its single fetch.
``block_verify``/``run_block_verify`` verify one request's block for the
reference engine (``engine.py::SpecDecEngine``); ``run_block_verify``
fetches the result in ONE device-to-host transfer.  The
rejection-sampling strategies are a later slice (ROADMAP).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.kernels.gls_race.ops import gls_row_race

_TINY = 1e-30

BACKENDS = ("torch", "kernel")
RACE_STRATEGIES = ("gls", "gls_strong", "daliri")


class BlockVerifyResult(NamedTuple):
    tokens: torch.Tensor        # (R, L+1) int64; [:num_accepted+1] valid
    num_accepted: torch.Tensor  # (R,) int64 accepted DRAFT tokens
    bonus: torch.Tensor         # (R,) bool -- all L accepted
    active: torch.Tensor        # (R, K) bool final active mask


class HostBlockResult(NamedTuple):
    """Host-side unpacked block outcome (what the reference engine
    consumes)."""
    new_tokens: list            # python ints, length num_accepted + 1
    num_accepted: int
    active: np.ndarray          # (K,) bool
    host_syncs: int             # device-to-host transfers spent verifying


def _race_row_stats(log_u: torch.Tensor, q_steps: torch.Tensor,
                    backend: str):
    """log_u/q_steps: (B, K, N) -> (rmin, rarg), each (B, K): the minimum
    race time ``log(-log U) - log q`` over the vocab and its argmin."""
    log_s = torch.log(-log_u)
    if backend == "kernel":
        neg_inf = torch.full((), float("-inf"), dtype=q_steps.dtype,
                             device=q_steps.device)
        log_q = torch.where(q_steps > 0,
                            torch.log(torch.clamp(q_steps, min=_TINY)),
                            neg_inf)
        rmin, rarg = gls_row_race(log_s.contiguous(), log_q.contiguous())
        return rmin, rarg.to(torch.int64)
    score = log_s - torch.log(torch.clamp(q_steps, min=_TINY))
    score = torch.where(q_steps > 0, score,
                        torch.full((), float("inf"), dtype=score.dtype,
                                   device=score.device))
    rmin, rarg = torch.min(score, dim=-1)
    return rmin, rarg


def _race_block(strategy: str, rmin: torch.Tensor, rarg: torch.Tensor,
                draft_tokens: torch.Tensor, q_all: torch.Tensor,
                strat_keys: torch.Tensor) -> BlockVerifyResult:
    """The L-step loop over (R, L+1, K) row statistics.
    draft_tokens (R, K, L); q_all (R, K, L+1, N); strat_keys (R, L+1, 2)."""
    r_n, l1, k = rmin.shape
    l = l1 - 1
    dev = rmin.device
    inf = torch.full((), float("inf"), dtype=rmin.dtype, device=dev)
    e0 = torch.zeros((r_n, k), dtype=torch.bool, device=dev)
    e0[:, 0] = True
    active = torch.ones((r_n, k), dtype=torch.bool, device=dev)
    alive = torch.ones((r_n,), dtype=torch.bool, device=dev)
    num_acc = torch.zeros((r_n,), dtype=torch.int64, device=dev)
    draft_tokens = draft_tokens.to(torch.int64)
    step_tokens = []
    for j in range(l):
        if strategy == "gls":
            mask = active
        elif strategy == "gls_strong":
            mask = torch.ones_like(active)
        else:  # daliri: race along draft 0's path only
            mask = e0
        masked = torch.where(mask, rmin[:, j], inf)
        k_star = torch.argmin(masked, dim=1, keepdim=True)
        token = torch.gather(rarg[:, j], 1, k_star)[:, 0]
        d_j = draft_tokens[:, :, j]
        if strategy == "daliri":
            acc = token == d_j[:, 0]
            new_active = e0
        else:
            new_active = active & (d_j == token[:, None])
            acc = new_active.any(dim=1)
        take = alive & acc
        active = torch.where(take[:, None], new_active, active)
        num_acc = num_acc + take.to(torch.int64)
        alive = alive & acc
        step_tokens.append(token)

    # Bonus token Y_{L+1} (meaningful only when all L steps accepted).
    if strategy in ("gls", "gls_strong"):
        act_b = active if strategy == "gls" else torch.ones_like(active)
        masked = torch.where(act_b, rmin[:, l], inf)
        bonus_tok = torch.gather(
            rarg[:, l], 1, torch.argmin(masked, dim=1, keepdim=True))[:, 0]
    else:  # daliri: the categorical bonus branch of the legacy loop
        k_idx = torch.argmax(active.to(torch.uint8), dim=1)
        q_last = q_all[torch.arange(r_n, device=dev), k_idx, l]   # (R, N)
        bonus_tok = R.categorical(strat_keys[:, l],
                                  torch.log(torch.clamp(q_last, min=1e-30)))
    tokens = torch.stack(step_tokens + [bonus_tok], dim=1)
    return BlockVerifyResult(tokens=tokens, num_accepted=num_acc,
                             bonus=alive, active=active)


def block_verify_batched(log_u: torch.Tensor, draft_tokens: torch.Tensor,
                         q_all: torch.Tensor, strat_keys: torch.Tensor, *,
                         strategy: str = "gls",
                         backend: str = "torch") -> BlockVerifyResult:
    """Batched Algorithm-2 verification for R requests, device-resident.

    log_u (R, L+1, K, N) shared log-uniforms; draft_tokens (R, K, L);
    q_all (R, K, L+1, N) target distributions along each draft path;
    strat_keys (R, L+1, 2) per-step keys (only daliri's bonus draws from
    them).  The R and L+1 axes collapse into ONE row-statistics pass of
    (R*(L+1), K, N)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown verifier backend {backend!r}")
    if strategy not in RACE_STRATEGIES:
        raise ValueError(
            f"strategy {strategy!r} is not ported (the rejection-sampling "
            "verifiers are ROADMAP queue 1, item 9)")
    r, l1, k, n = log_u.shape
    q_steps = q_all.transpose(1, 2).reshape(r * l1, k, n)
    rmin, rarg = _race_row_stats(log_u.reshape(r * l1, k, n), q_steps,
                                 backend)
    return _race_block(strategy, rmin.reshape(r, l1, k),
                       rarg.reshape(r, l1, k), draft_tokens, q_all,
                       strat_keys)


def block_verify(log_u: torch.Tensor, draft_tokens: torch.Tensor,
                 q_all: torch.Tensor, strat_keys: torch.Tensor, *,
                 strategy: str = "gls",
                 backend: str = "torch") -> BlockVerifyResult:
    """One request's block (``block_verify.py:206``): log_u (L+1, K, N),
    draft_tokens (K, L), q_all (K, L+1, N), strat_keys (L+1, 2).  The
    R = 1 case of ``block_verify_batched``, so the race runs as one
    (L+1, K, N) pass, as JAX's does; the leaves lose the R axis."""
    res = block_verify_batched(log_u[None], draft_tokens[None], q_all[None],
                               strat_keys[None], strategy=strategy,
                               backend=backend)
    return BlockVerifyResult(*(t[0] for t in res))


def run_block_verify(log_u: torch.Tensor, draft_tokens, q_all: torch.Tensor,
                     strat_keys: torch.Tensor, *, strategy: str,
                     backend: str = "torch") -> HostBlockResult:
    """Run ``block_verify`` and unpack it on the host
    (``block_verify.py:348``): tokens, the accepted count and the active
    mask come back packed in ONE device-to-host transfer."""
    res = block_verify(log_u, torch.as_tensor(draft_tokens,
                                              device=log_u.device),
                       q_all, strat_keys, strategy=strategy, backend=backend)
    l1 = res.tokens.shape[0]
    packed = torch.cat([res.tokens, res.num_accepted.reshape(1),
                        res.active.to(torch.int64)]).cpu().numpy()
    a = int(packed[l1])
    return HostBlockResult(new_tokens=[int(t) for t in packed[:a + 1]],
                           num_accepted=a, active=packed[l1 + 1:] != 0,
                           host_syncs=1)
