"""beta-VAE distributed image compression (paper Sec. 5 "Lossy compression
on MNIST" + App. D.3) on the offline synthetic digits -- the port's
counterpart of ``repro/compression/vae.py``.

Pipeline (the paper's Fig. 1):
  * encoder net: source image (right half, 1x28x14) -> Gaussian posterior
    p_{W|A} = N(e1(a), diag(e2(a))) over a 4-d latent; prior p_W = N(0, I).
  * decoder net: (w, projected side-info features) -> reconstruction.
  * projection net: 7x7 side-info crop -> 128-d features.
  * estimator net: (w, side-info) -> sigmoid classifier of joint vs
    product, whose odds h/(1-h) estimate the density ratio
    p_{W|T}(w|t)/p_W(w) -- the decoder importance weight lambda_p^(k).
  * coding: importance-sampled conditional GLS over N prior draws U_i
    with random bin ids l_i in [0, l_max) (App. C).  ``compress_batch``
    codes a batch of images through ``compression/pipeline.py``: the net
    forwards, the stacked race tables and, with ``backend="kernel"``,
    ONE ``gls_binned_race`` launch (JAX's "pallas"; "torch" is its
    "xla", the sequenced oracle); ``compress_image`` is the per-image
    wrapper.

Keys are the port's threefry keys (``random.py``), so a model, its
training batches' noise and its coding draws match JAX's for the same
key: the training data come from the same ``np.random.default_rng(0)``
stream, the weights and the atoms from the same ``split`` keys.  The
entry points that own a device (``train_vae``, ``evaluate_rd``) run on
the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch.compression import nets as N
from repro_torch.compression.pipeline import chunked_batch_map, wz_round_batch
from repro_torch.compression.wz import make_bins
from repro_torch.data.mnist import wz_split
from repro_torch.device import resolve_device, to_device
from repro_torch.models.mamba2 import softplus
from repro_torch.optim import adam_init, adam_update, tree_map
from repro_torch.serving.guard import validate_wz_batch
from repro_torch.train.loop import value_and_grad

LATENT = 4
# JAX's float32 constants 2 pi and log(2 pi) (``jnp.log`` of the float32
# 2 pi), correctly rounded.
_TWO_PI = float(np.float32(2 * math.pi))
_LOG_TWO_PI = float(np.float32(math.log(_TWO_PI)))


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def init_vae(key: torch.Tensor) -> dict:
    """The codec's nets from one key (``vae.py:42``), on its device."""
    ks = R.split(key, 16)
    return {
        # Encoder: 1x28x14 -> mu/logvar in R^4.
        "enc": {
            "c1": N.conv_params(ks[0], 1, 64, 3),
            "c2": N.conv_params(ks[1], 64, 64, 3),     # stride 2: 14x7
            "c3": N.conv_params(ks[2], 64, 64, 3),     # stride 2: 7x4
            "f1": N.fc_params(ks[3], 64 * 7 * 4, 256),
            "f2": N.fc_params(ks[4], 256, 2 * LATENT),
        },
        # Decoder: (w 4) + (side feats 128) -> 1x28x14.
        "dec": {
            "f1": N.fc_params(ks[5], LATENT + 128, 256),
            "f2": N.fc_params(ks[6], 256, 64 * 7 * 4),
            "u1": N.upconv_params(ks[7], 64, 32, 3),   # 7x4 -> 14x8
            "u2": N.upconv_params(ks[8], 32, 16, 3),   # 14x8 -> 28x16
            "c_out": N.conv_params(ks[9], 16, 1, 3),
        },
        # Projection: 1x7x7 crop -> 128 features.
        "proj": {
            "c1": N.conv_params(ks[10], 1, 32, 3),
            "c2": N.conv_params(ks[11], 32, 64, 3),    # stride 2: 4x4
            "f1": N.fc_params(ks[12], 64 * 4 * 4, 128),
        },
        # Estimator: (w, side feats) -> logit of joint-vs-product.
        "est": {
            "f1": N.fc_params(ks[13], 128 + LATENT, 128),
            "f2": N.fc_params(ks[14], 128, 128),
            "f3": N.fc_params(ks[15], 128, 1),
        },
    }


def encode(p, img):
    """img: (B, 28, 14) -> (mu, logvar) each (B, 4)."""
    x = img[:, None, :, :]
    x = F.relu(N.conv(p["c1"], x, 1, 1))
    x = F.relu(N.conv(p["c2"], x, 2, 1))
    x = F.relu(N.conv(p["c3"], x, 2, 1))
    x = x.reshape(x.shape[0], -1)
    x = F.relu(N.fc(p["f1"], x))
    out = N.fc(p["f2"], x)
    mu, logvar = out[:, :LATENT], out[:, LATENT:]
    return mu, torch.clamp(logvar, -8.0, 4.0)


def project(p, crop):
    """crop: (B, 7, 7) -> (B, 128)."""
    x = crop[:, None, :, :]
    x = F.relu(N.conv(p["c1"], x, 1, 1))
    x = F.relu(N.conv(p["c2"], x, 2, 1))
    x = x.reshape(x.shape[0], -1)
    return F.relu(N.fc(p["f1"], x))


def decode(p, w, feats):
    """(B,4) latent + (B,128) side features -> (B, 28, 14) in [0,1]."""
    x = torch.cat([w, feats], dim=-1)
    x = F.relu(N.fc(p["f1"], x))
    x = F.relu(N.fc(p["f2"], x)).reshape(-1, 64, 7, 4)
    x = F.relu(N.upconv(p["u1"], x))           # 7x4 -> 14x8
    x = F.relu(N.upconv(p["u2"], x))           # 14x8 -> 28x16
    x = N.conv(p["c_out"], x, 1, 1)[:, 0, :, :14]  # crop pad: 28x14
    return torch.sigmoid(x)


def estimator_logit(p, w, feats):
    """(..., 4) latents and (..., 128) side features -> (...) logits."""
    x = torch.cat([feats, w], dim=-1)
    x = F.leaky_relu(N.fc(p["f1"], x))
    x = F.leaky_relu(N.fc(p["f2"], x))
    return N.fc(p["f3"], x)[..., 0]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    beta: float = 0.35
    lr: float = 1e-3
    steps: int = 400
    batch: int = 64


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean``: the sum over a 0-dim float32 count."""
    return torch.sum(x) / torch.full((), float(x.numel()),
                                     dtype=torch.float32, device=x.device)


def vae_loss(params, key, source, crop, beta):
    """(mse + beta kl + the estimator's BCE, {"mse", "kl", "bce"})
    (``vae.py:129``): the posterior sample draws its noise from ``key``;
    the estimator sees joint pairs and pairs with w rolled by one row."""
    mu, logvar = encode(params["enc"], source)
    eps = R.normal(key, tuple(mu.shape))
    w = mu + torch.exp(0.5 * logvar) * eps
    feats = project(params["proj"], crop)
    recon = decode(params["dec"], w, feats)
    mse = _mean(torch.sum((recon - source) ** 2, dim=(1, 2)))
    kl = 0.5 * _mean(torch.sum(
        torch.exp(logvar) + mu ** 2 - 1.0 - logvar, dim=-1))
    logit_joint = estimator_logit(params["est"], w, feats)
    w_shuf = torch.roll(w, 1, dims=0)
    logit_prod = estimator_logit(params["est"], w_shuf, feats)
    bce = _mean(softplus(-logit_joint)) + _mean(softplus(logit_prod))
    return mse + beta * kl + bce, {"mse": mse, "kl": kl, "bce": bce}


def train_vae(key: torch.Tensor, images: np.ndarray, cfg: VAETrainConfig,
              *, device=None, log=print) -> dict:
    """images: (n, 28, 28) synthetic digits.  Returns the trained params
    on the device (``vae.py:148``): the nets from ``fold_in(key, 0)``,
    batches and side-info crops from ``np.random.default_rng(0)``, each
    step's noise from a ``split`` of the running key, Adam at
    ``cfg.lr``.  Losses come to the host every 100 steps and at the
    last."""
    dev = resolve_device(device)
    key = key.to(dev)
    params = init_vae(R.fold_in(key, 0))
    opt = adam_init(params)
    rng = np.random.default_rng(0)
    for i in range(cfg.steps):
        idx = rng.integers(0, len(images), cfg.batch)
        src, crop = wz_split(images[idx], rng)
        keys = R.split(key)
        key, sub = keys[0], keys[1]
        src, crop = to_device(src, dev), to_device(crop, dev)
        (loss, metrics), grads = value_and_grad(
            lambda p: vae_loss(p, sub, src, crop, cfg.beta), params)
        with torch.no_grad():
            params, opt, _ = adam_update(params, grads, opt, cfg.lr)
        if i % 100 == 0 or i == cfg.steps - 1:
            log(f"vae step {i:4d} loss {float(loss):.4f} "
                f"mse {float(metrics['mse']):.4f} "
                f"kl {float(metrics['kl']):.3f}")
    return params


# ---------------------------------------------------------------------------
# Coding with GLS
# ---------------------------------------------------------------------------


@torch.no_grad()
def compress_batch(keys, params, sources, crops, *, n_atoms: int,
                   l_max: int, k: int, shared_sheet: bool = False,
                   backend: str = "torch"):
    """Compress B sources (B,28,14) for K decoders each (crops
    (B,K,7,7); keys (B, 2)) on their device (``vae.py:180``).

    Per image b: atoms U_i ~ p_W = N(0, I_4); encoder weight
    log lambda_q,i = log N(U_i; mu(a_b), sigma^2(a_b)) - log N(U_i; 0,
    I); decoder weight log lambda_p,i^(k) = the estimator's
    joint-vs-product logit (log h/(1-h) estimates log p_{W|T}/p_W).  All
    B (K+1) races resolve in one ``gls_binned_race`` launch under
    ``backend="kernel"``.

    Returns (recons (B,K,28,14), code (WZBatch), mse (B,K)) -- the raw
    code rides out so host boundaries can guard it."""
    b = sources.shape[0]
    ks = R.split(keys, 3)
    k_atoms, k_bins, k_race = ks[:, 0], ks[:, 1], ks[:, 2]
    atoms = R.normal(k_atoms, (n_atoms, LATENT))            # (B, N, 4)

    mu, logvar = encode(params["enc"], sources)             # (B, 4)
    var = torch.exp(logvar)
    # log lambda_q,i = log N(U_i; mu, var) - log N(U_i; 0, 1)
    log_q = torch.sum(-0.5 * (torch.log(_TWO_PI * var)[:, None]
                              + (atoms - mu[:, None]) ** 2 / var[:, None]),
                      dim=-1)                               # (B, N)
    log_prior = torch.sum(-0.5 * (_LOG_TWO_PI + atoms ** 2), dim=-1)
    log_w_enc = log_q - log_prior

    feats = project(params["proj"],
                    crops.reshape(b * k, 7, 7)).reshape(b, k, -1)
    # Estimator odds stand in for lambda_p,i^(k) per (atom, decoder).
    log_w_dec = estimator_logit(
        params["est"], atoms[:, None].expand(b, k, n_atoms, LATENT),
        feats[:, :, None].expand(b, k, n_atoms, feats.shape[-1]))

    bins = make_bins(k_bins, n_atoms, l_max)
    code = wz_round_batch(k_race, log_w_enc, log_w_dec, bins, l_max=l_max,
                          shared_sheet=shared_sheet, backend=backend)
    w_dec = torch.gather(atoms, 1, code.x.long()[..., None].expand(
        b, k, LATENT))                                      # (B, K, 4)
    recons = decode(params["dec"], w_dec.reshape(b * k, LATENT),
                    feats.reshape(b * k, -1)).reshape(b, k, 28, 14)
    sq = torch.sum((recons - sources[:, None]) ** 2, dim=(2, 3))
    mse = sq / torch.full((), 28.0 * 14.0, dtype=torch.float32,
                          device=sq.device)
    return recons, code, mse


def compress_image(key, params, source, crops, *, n_atoms: int,
                   l_max: int, k: int, shared_sheet: bool = False,
                   backend: str = "torch"):
    """Compress ONE source (28,14) for K decoders with crops (K,7,7) --
    the B = 1 lane of ``compress_batch`` (``vae.py:232``).

    Returns (recons (K,28,14), match (K,), mse_best)."""
    recons, code, mse = compress_batch(
        key[None], params, source[None], crops[None], n_atoms=n_atoms,
        l_max=l_max, k=k, shared_sheet=shared_sheet, backend=backend)
    return recons[0], code.match[0], torch.amin(mse[0])


def rd_inputs(images: np.ndarray, k: int, trials: int, seed: int = 0):
    """``evaluate_rd``'s test sources (T, 28, 14) and crops (T, K, 7, 7),
    numpy, drawn host-side from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(images), trials)
    sources, crops = [], []
    for j in idx:
        srcs, crop0 = wz_split(np.repeat(images[j:j + 1], k, 0), rng)
        sources.append(srcs[0])
        crops.append(crop0)
    return np.stack(sources), np.stack(crops)


def evaluate_rd(key, params, images: np.ndarray, *, n_atoms: int = 512,
                l_max: int = 16, k: int = 2, trials: int = 128,
                shared_sheet: bool = False, seed: int = 0,
                backend: str = "torch", batch_size: int = 64,
                device=None) -> dict:
    """Rate-distortion point over ``trials`` random test images
    (``vae.py:247``), on the card unless ``device="cpu"``.

    Test images and crops are prepared host-side (``rd_inputs``), then
    coded in fixed-size ``compress_batch`` chunks (the tail chunk padded
    and discarded), one race launch per chunk under ``backend="kernel"``;
    every chunk's code is validated on the host (``validate_wz_batch``).
    Returns JAX's dict (rate_bits, mse, match_prob_any)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    sources, crops = rd_inputs(images, k, trials, seed)

    def batch_fn(kk, s, c):
        _, code, mse = compress_batch(
            kk, params, s, c, n_atoms=n_atoms, l_max=l_max, k=k,
            shared_sheet=shared_sheet, backend=backend)
        # recons stay on the device; code fields ride out for the guard.
        return (code.match, torch.amin(mse, dim=1),
                code.y, code.message, code.x, code.ok)

    def _guard(res):
        match_c, _, y_c, msg_c, x_c, ok_c = res
        validate_wz_batch(y_c, msg_c, x_c, match_c, ok_c,
                          n_atoms=n_atoms, l_max=l_max,
                          what="vae wz chunk")

    match, mse, *_ = chunked_batch_map(
        batch_fn, (R.split(key.to(dev), trials), to_device(sources, dev),
                   to_device(crops, dev)),
        trials, batch_size, validate=_guard)
    return {"rate_bits": float(np.log2(l_max)), "mse": float(np.mean(mse)),
            "match_prob_any": float(np.mean(match.any(axis=1)))}
