"""Plain PyTorch version of the SSD intra-chunk kernel -- the port's
counterpart of ``repro/kernels/ssd_chunk/ref.py::ssd_chunk_ref``.

CPU tensors take this route; ``chip_smoke.py`` holds the CUDA kernel
against it on the card.  For each (batch, chunk, head) tile it computes
the decay-masked quadratic output and the chunk summary state (Mamba-2 /
SSD, arXiv:2405.21060)."""

from __future__ import annotations

import torch


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor):
    """x: (B, NC, Q, H, P); dt: (B, NC, Q, H) f32 (already softplus'd);
    a: (H,) f32 negative; b_in/c_in: (B, NC, Q, N).

    Returns (y_intra (B, NC, Q, H, P) f32, states (B, NC, H, P, N) f32,
    total (B, NC, H) f32, the log-decay across each chunk).

    The decay mask is the reference's double ``where``: entries above
    the diagonal (where ``cum_i - cum_j > 0`` would overflow ``exp``)
    are zeroed before the ``exp`` and again after it."""
    q = x.shape[2]
    la = dt * a[None, None, None, :]
    cum = torch.cumsum(la, dim=2)                          # (B, NC, Q, H)
    total = cum[:, :, -1]
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    zero = torch.zeros((), dtype=cum.dtype, device=cum.device)
    diff = torch.where(mask, li - lj, zero)
    decay = torch.where(mask, torch.exp(diff), zero)       # (B,NC,Q,Q,H)
    cb = torch.einsum("bcin,bcjn->bcij", c_in.float(), b_in.float())
    w = cb[..., None] * decay
    xdt = x.float() * dt[..., None]                        # (B,NC,Q,H,P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xdt)
    rem = torch.exp(total[:, :, None, :] - cum)            # (B, NC, Q, H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", rem, b_in.float(), xdt)
    return y_intra, states, total
