"""Wyner-Ziv-style distributed lossy compression with GLS (paper Sec. 5,
App. C) -- the port's counterpart of ``repro/compression/wz.py``.

One encoder broadcasts a ``log2(l_max)``-bit message to K decoders, each
holding independent side information T_k.  Samples live on N importance
atoms -- prior draws U_1..U_N ~ p_W with uniformly random bin ids
l_1..l_N in [0, l_max).  The encoder races shared Exp(1) sheets over
the importance weights

    lambda_q,i = p_{W|A}(U_i | a) / p_W(U_i)

selects Y = U_{i*} and transmits the bin id M = l_{i*}.  Decoder k races
the SAME sheets over its own ratio lambda_p,i^(k) = p_{W|T}(U_i | t_k) /
p_W(U_i) restricted to the transmitted bin (``1{l_i = M}``); a match
(X^(k) = Y) reproduces the encoder's sample exactly.
``shared_sheet=True`` is the paper's common-randomness baseline: every
decoder reuses sheet 0, and the encoder races only sheet 0.

This module is the per-sample oracle; the batched path with one
``gls_binned_race`` launch per batch is ``compression/pipeline.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R

_TINY = float(np.finfo(np.float32).tiny)


class WZCode(NamedTuple):
    """One encode/decode outcome (App. C notation): ``y`` the encoder's
    atom index i*, ``message`` the bin id M = l_{i*}, ``x`` (K,) the
    decoders' atom indices, ``match`` (K,) the events X^(k) == Y."""

    y: torch.Tensor
    message: torch.Tensor
    x: torch.Tensor
    match: torch.Tensor


def _race_tables(key: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """log S for K shared sheets of N Exp(1) race times: (..., K, N).
    ``max(S, tiny)`` only guards the measure-zero draw S == 0."""
    return torch.log(torch.clamp(R.exponential(key, (k, n)), min=_TINY))


def _dead_to_inf(score: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(log_w), score,
                       torch.full((), float("inf"), dtype=score.dtype,
                                  device=score.device))


def wz_round(key: torch.Tensor, log_w_enc: torch.Tensor,
             log_w_dec: torch.Tensor, bins: torch.Tensor, k: int,
             shared_sheet: bool = False) -> WZCode:
    """One encode/decode round.  log_w_enc (N,) log lambda_q; log_w_dec
    (K, N) log lambda_p^(k); bins (N,) int bin ids in [0, l_max).

    Encoder: Y = argmin_i min_k S_i^(k) / lambda_q,i (sheet 0 only under
    ``shared_sheet``).  Decoders: weights outside the transmitted bin
    become -inf, then X^(k) = argmin_i S_i^(k) / lambda_p,i^(k).  Atoms
    with a non-finite log-weight never win."""
    log_s = _race_tables(key, k, log_w_enc.shape[-1])
    enc_sheet = log_s[0] if shared_sheet else torch.amin(log_s, dim=0)
    y = torch.argmin(_dead_to_inf(enc_sheet - log_w_enc, log_w_enc))
    message = bins[y]
    dec_w = torch.where((bins == message)[None, :], log_w_dec,
                        torch.full((), float("-inf"), dtype=log_w_dec.dtype,
                                   device=log_w_dec.device))
    sheets = log_s[0:1].expand(k, -1) if shared_sheet else log_s
    x = torch.argmin(_dead_to_inf(sheets - dec_w, dec_w), dim=-1)
    return WZCode(y=y.to(torch.int32), message=message,
                  x=x.to(torch.int32), match=x == y)


def make_bins(key: torch.Tensor, n: int, l_max: int) -> torch.Tensor:
    """Random binning l_i ~ Unif[0, l_max) of the N atoms: (..., N) i32."""
    return R.randint(key, (n,), 0, l_max)
