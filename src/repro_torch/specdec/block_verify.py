"""Device-side block verification (paper Sec. 4, Algorithm 2) -- the
port's counterpart of ``repro/specdec/block_verify.py``.

Race family ("gls", "gls_strong", "daliri"): the (L+1, K, N) race table
of a block is FIXED (only the (K,) active mask evolves), so it collapses
to per-row (min, argmin) statistics in one batched pass
(``_race_row_stats``) and the L-step loop runs on (L+1, K) scalars
(``_race_block``), with masked ``alive`` propagation instead of early
exit.  Backends: ``"torch"`` (the twin of JAX's "xla": plain tensor
ops) and ``"kernel"`` (the twin of "pallas": the ``gls_row_race`` CUDA
kernel on the card, its plain version on the CPU).  The two compute the
same score floats with the same mask, so their outputs are bit-identical.

Rejection-sampling family ("specinfer", "spectr", "single"):
``_rs_block`` runs the step verifiers of ``verify.py`` over the L steps
with the same masked propagation, on JAX's per-step keys
(``strat_keys[j]``); the noise of all L steps is drawn in one pass.
These verifiers read the drafter's step distributions (``draft_probs``)
and have no kernel: both device backends run them as tensor ops.

``block_verify_batched`` takes a leading request axis R and performs no
host transfer: the fused round packs the result into its single fetch.
``block_verify``/``run_block_verify`` verify one request's block for the
reference engine (``engine.py::SpecDecEngine``); ``run_block_verify``
fetches the result in ONE device-to-host transfer, or, with
``backend="legacy"``, replays the per-token host loop
(``legacy_block_verify``, two host syncs per step) that JAX keeps as
its equivalence oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.kernels.gls_race.ops import gls_row_race
from repro_torch.specdec import verify as V

_TINY = 1e-30

BACKENDS = ("legacy", "torch", "kernel")
RACE_STRATEGIES = ("gls", "gls_strong", "daliri")
# Rejection-sampling strategies: their verifiers read the drafter's step
# distributions (the race family is drafter-invariant and never does).
RS_STRATEGIES = ("specinfer", "spectr", "single")


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


def _bonus_categorical(g_bonus: torch.Tensor, active: torch.Tensor,
                       q_last: torch.Tensor) -> torch.Tensor:
    """The categorical bonus token Y_{L+1} (``block_verify.py:193-196``):
    drawn from q along the first active row.  g_bonus (R, N) Gumbel
    noise of ``strat_keys[:, L]``, active (R, K), q_last (R, K, N)."""
    k_idx = torch.argmax(active.to(torch.uint8), dim=1)
    q_row = torch.gather(q_last, 1, k_idx[:, None, None].expand(
        -1, 1, q_last.shape[-1]))[:, 0]
    return torch.argmax(g_bonus + torch.log(torch.clamp(q_row, min=1e-30)),
                        dim=-1)


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
        bonus_tok = _bonus_categorical(
            R.gumbel(strat_keys[:, l], (q_all.shape[-1],)), active,
            q_all[:, :, l])
    tokens = torch.stack(step_tokens + [bonus_tok], dim=1)
    return BlockVerifyResult(tokens=tokens, num_accepted=num_acc,
                             bonus=alive, active=active)


def _rs_block(strategy: str, draft_tokens: torch.Tensor,
              draft_probs: torch.Tensor, q_all: torch.Tensor,
              strat_keys: torch.Tensor) -> BlockVerifyResult:
    """The L-step loop of the rejection-sampling strategies
    (``block_verify.py:160-198``), batched over R: draft_tokens (R, K,
    L), draft_probs (R, K, L, N), q_all (R, K, L+1, N), strat_keys (R,
    L+1, 2).  Step j runs its verifier on ``strat_keys[:, j]``; every
    step's noise and the bonus token's are drawn first, in one pass."""
    r_n, k, l = draft_tokens.shape
    n = q_all.shape[-1]
    dev = q_all.device
    num_tests = 1 if strategy == "single" else k
    keys = R.split(strat_keys[:, :l], num_tests + 1)     # (R, L, T+1, 2)
    u = R.uniform(keys[:, :, :num_tests], ())            # (R, L, T)
    # One Gumbel pass: each step's residual key, then the bonus key.
    g = R.gumbel(torch.cat([keys[:, :, num_tests], strat_keys[:, l:]], 1),
                 (n,))                                    # (R, L+1, N)
    e0 = torch.zeros((r_n, k), dtype=torch.bool, device=dev)
    e0[:, 0] = True
    active = torch.ones((r_n, k), dtype=torch.bool, device=dev)
    alive = torch.ones((r_n,), dtype=torch.bool, device=dev)
    num_acc = torch.zeros((r_n,), dtype=torch.int64, device=dev)
    draft_tokens = draft_tokens.to(torch.int64)
    step_tokens = []
    for j in range(l):
        d_j = draft_tokens[:, :, j]
        p_j, q_j = draft_probs[:, :, j], q_all[:, :, j]
        if strategy == "specinfer":
            res = V.specinfer_core(u[:, j], g[:, j], p_j, d_j, q_j, active)
            new_active = res.new_active
        elif strategy == "spectr":
            res = V.spectr_core(u[:, j], g[:, j], p_j, d_j, q_j, active)
            new_active = res.new_active
        else:  # single (Leviathan): draft 0 only, path continues on row 0
            res = V.single_draft_core(u[:, j], g[:, j], p_j[:, 0],
                                      d_j[:, 0], q_j[:, 0])
            new_active = e0
        take = alive & res.accepted
        active = torch.where(take[:, None], new_active, active)
        num_acc = num_acc + take.to(torch.int64)
        alive = alive & res.accepted
        step_tokens.append(res.token)
    bonus_tok = _bonus_categorical(g[:, l], active, q_all[:, :, l])
    tokens = torch.stack(step_tokens + [bonus_tok], dim=1)
    return BlockVerifyResult(tokens=tokens, num_accepted=num_acc,
                             bonus=alive, active=active)


def block_verify_batched(log_u: torch.Tensor, draft_tokens: torch.Tensor,
                         draft_probs: Optional[torch.Tensor],
                         q_all: torch.Tensor, strat_keys: torch.Tensor, *,
                         strategy: str = "gls",
                         backend: str = "torch") -> BlockVerifyResult:
    """Batched Algorithm-2 verification for R requests, device-resident.

    log_u (R, L+1, K, N) shared log-uniforms; draft_tokens (R, K, L);
    draft_probs (R, K, L, N) drafter step distributions (None for the
    race strategies); q_all (R, K, L+1, N) target distributions along
    each draft path; strat_keys (R, L+1, 2) per-step keys (the
    rejection-sampling steps and daliri's bonus draw from them).  For
    the race family the R and L+1 axes collapse into ONE row-statistics
    pass of (R*(L+1), K, N).  ``backend="legacy"`` is a host loop and
    cannot run here."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown verifier backend {backend!r}")
    if backend == "legacy":
        raise ValueError("the 'legacy' backend is a per-token host loop "
                         "(run_block_verify); batched verification needs "
                         "'torch' or 'kernel'")
    if strategy in RS_STRATEGIES:
        return _rs_block(strategy, draft_tokens, draft_probs, q_all,
                         strat_keys)
    if strategy not in RACE_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    r, l1, k, n = log_u.shape
    q_steps = q_all.transpose(1, 2).reshape(r * l1, k, n)
    rmin, rarg = _race_row_stats(log_u.reshape(r * l1, k, n), q_steps,
                                 backend)
    return _race_block(strategy, rmin.reshape(r, l1, k),
                       rarg.reshape(r, l1, k), draft_tokens, q_all,
                       strat_keys)


def block_verify(log_u: torch.Tensor, draft_tokens: torch.Tensor,
                 draft_probs: Optional[torch.Tensor], q_all: torch.Tensor,
                 strat_keys: torch.Tensor, *, strategy: str = "gls",
                 backend: str = "torch") -> BlockVerifyResult:
    """One request's block (``block_verify.py:206``): log_u (L+1, K, N),
    draft_tokens (K, L), draft_probs (K, L, N) or None, q_all (K, L+1,
    N), strat_keys (L+1, 2).  The R = 1 case of
    ``block_verify_batched``, so the race runs as one (L+1, K, N) pass,
    as JAX's does; the leaves lose the R axis."""
    res = block_verify_batched(
        log_u[None], draft_tokens[None],
        None if draft_probs is None else draft_probs[None], q_all[None],
        strat_keys[None], strategy=strategy, backend=backend)
    return BlockVerifyResult(*(t[0] for t in res))


def legacy_block_verify(log_u: torch.Tensor, draft_tokens,
                        draft_probs: Optional[torch.Tensor],
                        q_all: torch.Tensor, strat_keys: torch.Tensor, *,
                        strategy: str) -> HostBlockResult:
    """The per-token host loop (``block_verify.py:281-345``): one step
    verifier per token, the host reading each step's token and accepted
    flag (two syncs per step, as JAX counts them) and stopping at the
    first rejection.  Shapes as in ``block_verify``."""
    dev = q_all.device
    d = torch.as_tensor(np.asarray(draft_tokens), device=dev).to(
        torch.int64)
    k, l = d.shape
    out_tokens = []
    active = torch.ones((k,), dtype=torch.bool, device=dev)
    e0 = torch.zeros((k,), dtype=torch.bool, device=dev)
    e0[0] = True
    accepted_drafts = 0
    syncs = 0
    for j in range(l):
        q_j, d_j = q_all[:, j], d[:, j]
        if strategy == "gls":
            res = V.gls_verify(log_u[j], d_j, q_j, active)
        elif strategy == "gls_strong":
            res = V.gls_verify_strong(log_u[j], d_j, q_j, active)
        elif strategy == "specinfer":
            res = V.specinfer_verify(strat_keys[j], draft_probs[:, j], d_j,
                                     q_j, active)
        elif strategy == "spectr":
            res = V.spectr_verify(strat_keys[j], draft_probs[:, j], d_j,
                                  q_j, active)
        elif strategy == "single":
            res = V.single_draft_verify(strat_keys[j], draft_probs[0, j],
                                        d_j[0], q_j[0])
        elif strategy == "daliri":
            res = V.daliri_verify(log_u[j, 0], d_j[0], q_j[0])
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        out_tokens.append(int(res.token))
        syncs += 1
        if not bool(res.accepted):
            syncs += 1
            return HostBlockResult(new_tokens=out_tokens,
                                   num_accepted=accepted_drafts,
                                   active=active.cpu().numpy(),
                                   host_syncs=syncs)
        syncs += 1
        accepted_drafts += 1
        # Single-draft strategies continue only along draft 0's path.
        active = e0 if strategy in ("single", "daliri") else res.new_active

    # All L draft tokens accepted: emit the bonus token Y_{L+1}.
    q_last = q_all[:, l]
    if strategy in ("gls", "gls_strong"):
        act = active if strategy == "gls" else torch.ones_like(active)
        score = V.race_scores(log_u[l], q_last)
        score = torch.where(act[:, None], score,
                            torch.full((), float("inf"), dtype=score.dtype,
                                       device=dev))
        bonus = int(torch.argmin(score.reshape(-1))) % q_last.shape[-1]
    else:
        k_idx = int(torch.argmax(active.to(torch.uint8)))
        bonus = int(R.categorical(
            strat_keys[l], torch.log(torch.clamp(q_last[k_idx], min=1e-30))))
        syncs += 1
    syncs += 1
    out_tokens.append(bonus)
    return HostBlockResult(new_tokens=out_tokens,
                           num_accepted=accepted_drafts,
                           active=active.cpu().numpy(), host_syncs=syncs)


def run_block_verify(log_u: torch.Tensor, draft_tokens,
                     draft_probs: Optional[torch.Tensor],
                     q_all: torch.Tensor, strat_keys: torch.Tensor, *,
                     strategy: str, backend: str = "torch"
                     ) -> HostBlockResult:
    """Verify one request's block and unpack it on the host
    (``block_verify.py:348``).  The device backends bring tokens, the
    accepted count and the active mask back packed in ONE
    device-to-host transfer; "legacy" replays the per-token host loop."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown verifier backend {backend!r}")
    if backend == "legacy":
        return legacy_block_verify(log_u, draft_tokens, draft_probs, q_all,
                                   strat_keys, strategy=strategy)
    res = block_verify(log_u, torch.as_tensor(draft_tokens,
                                              device=log_u.device),
                       draft_probs, q_all, strat_keys, strategy=strategy,
                       backend=backend)
    l1 = res.tokens.shape[0]
    packed = torch.cat([res.tokens, res.num_accepted.reshape(1),
                        res.active.to(torch.int64)]).cpu().numpy()
    a = int(packed[l1])
    return HostBlockResult(new_tokens=[int(t) for t in packed[:a + 1]],
                           num_accepted=a, active=packed[l1 + 1:] != 0,
                           host_syncs=1)
