"""Plain PyTorch versions of the GLS race kernels -- the port's
counterparts of ``repro/kernels/gls_race/ref.py`` (``gls_row_race_ref``,
``gls_binned_race_ref``, ``gls_race_ref``).

CPU tensors take these routes; ``chip_smoke.py`` also holds each CUDA
kernel against its plain version on the card.  Every race masks a
non-finite log-weight to a race time of +inf (``isfinite``, as the
reference does) and breaks ties toward the lower index (``torch.min``
and ``torch.argmin`` return the first minimum)."""

from __future__ import annotations

import torch


def _masked_score(log_s: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    inf = torch.full((), float("inf"), dtype=log_s.dtype,
                     device=log_s.device)
    return torch.where(torch.isfinite(log_w), log_s - log_w, inf)


def gls_row_race_plain(log_s: torch.Tensor, log_q: torch.Tensor):
    """(rmin (B, K) f32, rarg (B, K) i32) of ``log_s - log_q`` over the
    last axis, with non-finite ``log_q`` masked to +inf."""
    rmin, rarg = torch.min(_masked_score(log_s, log_q), dim=-1)
    return rmin, rarg.to(torch.int32)


def gls_binned_race_plain(log_s: torch.Tensor, log_q: torch.Tensor,
                          bins: torch.Tensor, *, l_max: int):
    """Per-(row, sheet, bin) race statistics: (bmin (B, K, l_max) f32,
    barg (B, K, l_max) i32) of ``log_s - log_q`` over the atoms whose
    bin id (``bins`` (B, N)) equals each bin.  A bin with no live atom
    reports (inf, 0).  One reduction per bin, as the reference loops, so
    ties resolve the same way; the min is gathered at the argmin."""
    score = _masked_score(log_s, log_q)
    inf = torch.full((), float("inf"), dtype=score.dtype,
                     device=score.device)
    mins, args = [], []
    for l in range(l_max):
        s_l = torch.where((bins == l)[:, None, :], score, inf)
        arg = torch.argmin(s_l, dim=-1)
        mins.append(torch.gather(s_l, -1, arg[..., None])[..., 0])
        args.append(arg.to(torch.int32))
    return torch.stack(mins, dim=-1), torch.stack(args, dim=-1)


def gls_race_plain(log_s: torch.Tensor, log_p: torch.Tensor,
                   log_q: torch.Tensor, active: torch.Tensor):
    """The single-step joint race.  log_s/log_p/log_q: (B, K, N) f32;
    active: (B, K) bool.  Returns (x (B, K) i32, the per-draft argmins
    of ``log_s - log_p``; y (B,) i32, the argmin over n of the min over
    ACTIVE k of ``log_s - log_q``)."""
    x = torch.argmin(_masked_score(log_s, log_p), dim=-1)
    inf = torch.full((), float("inf"), dtype=log_s.dtype,
                     device=log_s.device)
    tgt = torch.where(active[..., None], _masked_score(log_s, log_q), inf)
    y = torch.argmin(torch.amin(tgt, dim=1), dim=-1)
    return x.to(torch.int32), y.to(torch.int32)
