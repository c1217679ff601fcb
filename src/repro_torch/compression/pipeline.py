"""Batched Wyner-Ziv engine on the ``gls_binned_race`` kernel -- the
port's counterpart of ``repro/compression/pipeline.py``.

``compression/wz.py`` runs ONE encode/decode round per call.  This
module runs B rounds as one batch of device work:

  * the per-round Exp(1) race sheets come from the B round keys at once
    (``_race_tables`` broadcast over the key axis, equal lane by lane to
    the per-round oracle);
  * ``backend="kernel"``: ONE ``gls_binned_race`` launch per batch over
    (B, K+1, N) -- K decoder rows plus one encoder row whose sheet is
    the elementwise ``min_k S^(k)``.  The decoder's ``1{l_i = M}`` mask
    depends on the encoder's outcome, so the race reduces per-(row,
    bin) (min, argmin) statistics in one pass over the atom axis: the
    encoder's winning bin IS the message M, its argmin is Y, and decoder
    k reads its (row k, bin M) statistic -- O(B K l_max) work after the
    race.  A CUDA tensor launches the kernel, a CPU tensor runs its
    plain version;
  * ``backend="torch"``: the sequenced oracle (the counterpart of JAX's
    ``"xla"``) -- encoder argmin, gather M, one bin-masked decoder
    reduction, plain tensor ops.

Both backends race the same score floats, so their outputs agree
outside float ties between bins (the kernel layout breaks an encoder tie
toward the lower bin, the oracle toward the lower atom).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compression.wz import _dead_to_inf, _race_tables
from repro_torch.kernels.gls_race.ops import gls_binned_race

BACKENDS = ("torch", "kernel")


class WZBatch(NamedTuple):
    """B stacked encode/decode outcomes: ``y`` (B,) i32, ``message`` (B,)
    i32, ``x`` (B, K) i32, ``match`` (B, K) bool and ``ok`` (B,) bool --
    every race of the round resolved on a FINITE score.  A poisoned
    weight row sanitises to dead atoms and argmin then returns index 0,
    in range; ``ok`` is computed where the scores still exist, and
    ``validate_wz_batch`` gates on it."""

    y: torch.Tensor
    message: torch.Tensor
    x: torch.Tensor
    match: torch.Tensor
    ok: torch.Tensor


def check_wz_batch(code: WZBatch, *, n_atoms: int, l_max: int,
                   what: str = "wz batch") -> WZBatch:
    """Fetch a WZ outcome to the host and validate it against the serving
    invariants (finite-score flag, index ranges, match consistency);
    raises ``GuardViolation``, else returns ``code`` unchanged."""
    from repro_torch.serving.guard import validate_wz_batch

    validate_wz_batch(*(t.cpu() for t in code), n_atoms=n_atoms,
                      l_max=l_max, what=what)
    return code


def chunked_batch_map(fn, arrays, trials: int, batch_size: int,
                      validate=None):
    """Stream ``trials`` rows through ``fn`` in fixed-size chunks.

    The tail chunk is padded by wrapping rows from the front, so every
    chunk has one shape; results come to the host chunk by chunk and the
    padding is dropped.  ``arrays`` share the leading trial axis;
    ``fn(*chunks)`` returns a tuple of per-trial tensors.  ``validate``
    runs on every chunk's host (numpy) results before they are kept:
    the host boundary where a poisoned batch must fail loudly.  Returns
    numpy arrays of length ``trials``."""
    batch = min(batch_size, trials)
    pad = (-trials) % batch
    if pad:
        arrays = tuple(torch.cat([a, a[:pad]]) for a in arrays)
    outs = None
    for i in range(0, trials + pad, batch):
        res = tuple(r.cpu().numpy()
                    for r in fn(*(a[i:i + batch] for a in arrays)))
        if validate is not None:
            validate(res)
        if outs is None:
            outs = tuple([] for _ in res)
        for acc, r in zip(outs, res):
            acc.append(r)
    return tuple(np.concatenate(acc)[:trials] for acc in outs)


def batched_race_tables(keys: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(B, K, N) log race sheets from the B round keys, lane by lane equal
    to ``_race_tables`` of each key."""
    return _race_tables(keys, k, n)


def wz_round_batch(keys: torch.Tensor, log_w_enc: torch.Tensor,
                   log_w_dec: torch.Tensor, bins: torch.Tensor, *,
                   l_max: int, shared_sheet: bool = False,
                   backend: str = "torch") -> WZBatch:
    """B encode/decode rounds: keys (B, 2), log_w_enc (B, N) log
    lambda_q, log_w_dec (B, K, N) log lambda_p^(k), bins (B, N) i32 in
    [0, l_max).  See the module docstring for the two backends; under
    ``shared_sheet`` every row races sheet 0.  Non-finite weights are
    dead atoms.  No host transfer."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown pipeline backend {backend!r}")
    b, k, n = log_w_dec.shape
    log_s = batched_race_tables(keys, k, n)                 # (B, K, N)
    dec_sheets = log_s[:, :1].expand(b, k, n) if shared_sheet else log_s
    enc_sheet = log_s[:, 0] if shared_sheet else torch.amin(log_s, dim=1)
    neg_inf = torch.full((), float("-inf"), dtype=log_s.dtype,
                         device=log_s.device)
    log_q_dec = torch.where(torch.isfinite(log_w_dec), log_w_dec, neg_inf)
    log_q_enc = torch.where(torch.isfinite(log_w_enc), log_w_enc, neg_inf)

    if backend == "kernel":
        # ONE launch: (B, K+1, l_max) per-bin (min, argmin) statistics.
        bmin, barg = gls_binned_race(
            torch.cat([dec_sheets, enc_sheet[:, None]], dim=1),
            torch.cat([log_q_dec, log_q_enc[:, None]], dim=1), bins,
            l_max=l_max)
        # The encoder row's winning bin is the message M (ties to the
        # lower bin), its argmin Y; decoder k reads (row k, bin M).
        message = torch.argmin(bmin[:, k], dim=-1)
        y = torch.gather(barg[:, k], 1, message[:, None])[:, 0]
        at_m = message[:, None, None].expand(b, k, 1)
        x = torch.gather(barg[:, :k], 2, at_m)[..., 0]
        enc_min = torch.gather(bmin[:, k], 1, message[:, None])[:, 0]
        dec_min = torch.gather(bmin[:, :k], 2, at_m)[..., 0]
        ok = torch.isfinite(enc_min) & torch.isfinite(dec_min).all(dim=-1)
    else:
        enc_score = _dead_to_inf(enc_sheet - log_q_enc, log_q_enc)
        y = torch.argmin(enc_score, dim=-1)
        message = torch.gather(bins, 1, y[:, None])[:, 0]
        in_bin = (bins == message[:, None])[:, None, :]
        inf = torch.full((), float("inf"), dtype=log_s.dtype,
                         device=log_s.device)
        dec_score = torch.where(in_bin & torch.isfinite(log_q_dec),
                                dec_sheets - log_q_dec, inf)
        x = torch.argmin(dec_score, dim=-1)                 # (B, K)
        ok = (torch.isfinite(torch.amin(enc_score, dim=-1))
              & torch.isfinite(torch.amin(dec_score, dim=-1)).all(dim=-1))

    y = y.to(torch.int32)
    x = x.to(torch.int32)
    return WZBatch(y=y, message=message.to(torch.int32), x=x,
                   match=x == y[:, None], ok=ok)


def wz_pipeline(keys, log_w_enc, log_w_dec, bins, *, l_max: int,
                shared_sheet: bool = False,
                backend: str = "torch") -> WZBatch:
    """Standalone entry over precomputed weights (the JAX version jits
    ``wz_round_batch``; eager PyTorch runs it as it stands)."""
    return wz_round_batch(keys, log_w_enc, log_w_dec, bins, l_max=l_max,
                          shared_sheet=shared_sheet, backend=backend)
