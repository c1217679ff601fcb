"""Plain PyTorch version of the ``gls_row_race`` kernel (the port's
counterpart of ``repro/kernels/gls_race/ref.py::gls_row_race_ref``).

CPU tensors take this route; ``chip_smoke.py`` also holds the CUDA
kernel against it on the card."""

from __future__ import annotations

import torch


def gls_row_race_plain(log_s: torch.Tensor, log_q: torch.Tensor):
    """(rmin (B, K) f32, rarg (B, K) i32) of ``log_s - log_q`` over the
    last axis, with non-finite ``log_q`` masked to +inf and ties going
    to the lower index (``torch.min`` returns the first minimum)."""
    score = log_s - log_q
    score = torch.where(torch.isfinite(log_q), score,
                        torch.full((), float("inf"), dtype=score.dtype,
                                   device=score.device))
    rmin, rarg = torch.min(score, dim=-1)
    return rmin, rarg.to(torch.int32)
