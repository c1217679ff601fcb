"""Synthetic Gaussian source experiment (paper Sec. 5 + App. D.2) -- the
port's counterpart of ``repro/compression/gaussian.py``.

  A ~ N(0,1);  T_k = A + zeta_k, zeta_k ~ N(0, s2_{T|A});
  encoder target  p_{W|A}(.|a) = N(a, s2_{W|A});
  decoder target  p_{W|T}(.|t) = N(t/s2_T, s2_W - 1/s2_T);
  MMSE reconstruction  g(w,t) = (s2_zeta w + s2_eta t)/(s2_eta + s2_zeta
                                                        + s2_eta s2_zeta).

Importance atoms are N prior draws U_i ~ p_W = N(0, s2_W); rate
R = log2(l_max) bits per sample; the estimate is the best of the K
decoders (the paper's "at least one decoder succeeds").

``simulate_trial`` is the per-sample oracle; ``run_experiment`` streams
trials through ``compression/pipeline.py`` in chunks -- weights, race
sheets, the one race launch and the reconstruction of a chunk all stay
on the device until its results are fetched.

Scalars: JAX rounds every Python float to float32 before an op touches
it, so the configuration's constants (variances, their square roots and
logs, the MMSE denominator) are formed in float32 here too.  Divisions
by a constant divide by a 0-dim tensor, as XLA does, not by a Python
scalar (PyTorch's CUDA division by a host scalar multiplies by its
reciprocal instead).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import random as R
from repro_torch.compression.pipeline import chunked_batch_map, wz_round_batch
from repro_torch.compression.wz import make_bins, wz_round
from repro_torch.core.bounds import wz_error_upper_bound
from repro_torch.device import resolve_device
from repro_torch.serving.guard import validate_wz_batch

_LN2 = float(np.float32(np.log(2.0)))


def _f32(v: float) -> float:
    """A Python float rounded to float32, as JAX rounds its scalars."""
    return float(np.float32(v))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a 0-dim tensor on ``like``'s device (a fill,
    not a host-to-device copy)."""
    return torch.full((), _f32(v), dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class GaussianWZ:
    sigma2_w_given_a: float = 0.01   # permitted distortion at the encoder
    sigma2_t_given_a: float = 0.5    # side-info noise
    n_atoms: int = 4096              # importance-sample count N

    @property
    def sigma2_w(self) -> float:
        return 1.0 + self.sigma2_w_given_a

    @property
    def sigma2_t(self) -> float:
        return 1.0 + self.sigma2_t_given_a

    def decoder_target(self, t: torch.Tensor):
        """(mean tensor, variance as a Python float) of p_{W|T}(.|t)."""
        mu = t / _const(self.sigma2_t, t)
        var = self.sigma2_w - 1.0 / self.sigma2_t
        return mu, var

    def mmse(self, w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        s_eta = self.sigma2_w_given_a
        s_zeta = self.sigma2_t_given_a
        return ((_f32(s_zeta) * w + _f32(s_eta) * t)
                / _const(s_eta + s_zeta + s_eta * s_zeta, w))


def _log_normal(x: torch.Tensor, mu, var: float) -> torch.Tensor:
    """log N(x; mu, var) for a Python-float variance, float32 throughout
    (``log(2 pi var)`` is the float32 log of the float32 product)."""
    log_2pi_var = _f32(math.log(_f32(2 * math.pi * var)))
    d = x - mu
    return -0.5 * (log_2pi_var + d * d / _const(var, x))


def _sqrt_f32(v: float) -> float:
    return float(np.sqrt(np.float32(v)))


def _trial_setup(key: torch.Tensor, cfg: GaussianWZ, k: int, l_max: int):
    """A trial's source, side info, atoms, importance weights and bins,
    for keys (..., 2): (k_race (..., 2), a (...), t (..., K), atoms
    (..., N), log_w_enc (..., N), log_w_dec (..., K, N), bins (..., N)).
    Shared by the per-sample oracle and the batched pipeline, so both
    consume identical randomness."""
    keys = R.split(key, 5)
    k_a, k_t, k_u, k_bins, k_race = (keys[..., i, :] for i in range(5))
    a = R.normal(k_a, ())
    t = a[..., None] + _sqrt_f32(cfg.sigma2_t_given_a) * R.normal(k_t, (k,))
    atoms = _sqrt_f32(cfg.sigma2_w) * R.normal(k_u, (cfg.n_atoms,))
    # Encoder weights: log lambda_q,i = log p_{W|A}(U_i|a) - log p_W(U_i).
    log_prior = _log_normal(atoms, 0.0, cfg.sigma2_w)
    log_w_enc = (_log_normal(atoms, a[..., None], cfg.sigma2_w_given_a)
                 - log_prior)
    # Decoder weights: log lambda_p,i^(k) = log p_{W|T}(U_i|t_k) - log p_W.
    mu_t, var_t = cfg.decoder_target(t)
    log_w_dec = (_log_normal(atoms[..., None, :], mu_t[..., :, None], var_t)
                 - log_prior[..., None, :])
    bins = make_bins(k_bins, cfg.n_atoms, l_max)
    return k_race, a, t, atoms, log_w_enc, log_w_dec, bins


def simulate_trial(key: torch.Tensor, cfg: GaussianWZ, k: int, l_max: int,
                   shared_sheet: bool = False):
    """One compression round through the per-sample oracle, on the key's
    device.  Returns (match (K,), sq_err_best, sq_errs (K,))."""
    k_race, a, t, atoms, log_w_enc, log_w_dec, bins = _trial_setup(
        key, cfg, k, l_max)
    code = wz_round(k_race, log_w_enc, log_w_dec, bins, k,
                    shared_sheet=shared_sheet)
    a_hat = cfg.mmse(atoms[code.x.long()], t)
    sq = (a_hat - a) ** 2
    return code.match, torch.amin(sq), sq


def _batch_trials(keys: torch.Tensor, cfg: GaussianWZ, k: int, l_max: int,
                  shared_sheet: bool, backend: str):
    """A chunk of trials, keys (B, 2): weights, ``wz_round_batch`` (one
    race launch on the kernel backend) and the MMSE reconstructions,
    with no host transfer, under the profiler ranges
    ``compress/{setup,race,reconstruct}``.  Returns (match, best squared error,
    information density in bits, y, message, x, ok)."""
    with record_function("compress/setup"):
        k_race, a, t, atoms, log_w_enc, log_w_dec, bins = _trial_setup(
            keys, cfg, k, l_max)
    with record_function("compress/race"):
        code = wz_round_batch(k_race, log_w_enc, log_w_dec, bins,
                              l_max=l_max, shared_sheet=shared_sheet,
                              backend=backend)
    with record_function("compress/reconstruct"):
        w_hat = torch.gather(atoms, 1, code.x.long())          # (B, K)
        sq = (cfg.mmse(w_hat, t) - a[:, None]) ** 2
        # Information density i(W;A|T) in bits at the selected atom (the
        # Prop.-4 statistic): log2 of lambda_q,Y over the decoders' mean
        # lambda_p,Y.
        y = code.y.long()
        w_enc_y = torch.gather(log_w_enc, 1, y[:, None])[:, 0]
        w_dec_y = torch.gather(log_w_dec, 2,
                               y[:, None, None].expand(-1, k, 1))[..., 0]
        info_bits = ((w_enc_y - (torch.logsumexp(w_dec_y, dim=1)
                                 - _f32(math.log(_f32(k)))))
                     / _const(_LN2, w_enc_y))
    return (code.match, torch.amin(sq, dim=1), info_bits, code.y,
            code.message, code.x, code.ok)


def run_experiment(key: torch.Tensor, cfg: GaussianWZ, k: int, l_max: int,
                   trials: int, shared_sheet: bool = False, *,
                   backend: str = "torch", batch_size: int = 512,
                   device=None):
    """Trials in chunks of ``batch_size`` through the Wyner-Ziv pipeline,
    on the card unless ``device="cpu"``.  Every chunk's outcome is
    validated on the host (``validate_wz_batch``).  Returns the JAX
    version's dict: match probabilities, ``match_lower_bound`` (the
    Prop.-4 bound ``1 - wz_error_upper_bound`` from the trials'
    information densities), distortion and rate."""
    dev = resolve_device(device)
    keys = R.split(key.to(dev), trials)

    def guard(res):
        match_c, _, _, y_c, msg_c, x_c, ok_c = res
        validate_wz_batch(y_c, msg_c, x_c, match_c, ok_c,
                          n_atoms=cfg.n_atoms, l_max=l_max,
                          what="gaussian wz chunk")

    match, best_sq, infos, *_ = chunked_batch_map(
        lambda kk: _batch_trials(kk, cfg, k, l_max, shared_sheet, backend),
        (keys,), trials, batch_size, validate=guard)
    return {
        "match_prob_any": float(np.mean(match.any(axis=-1))),
        "match_prob_each": float(np.mean(match)),
        "match_lower_bound": float(
            1.0 - wz_error_upper_bound(torch.from_numpy(infos), k, l_max)),
        "distortion": float(np.mean(best_sq)),
        "distortion_db": float(10 * np.log10(np.mean(best_sq))),
        "rate_bits": float(np.log2(l_max)),
    }
