"""Counter-based threefry2x32 keys and samplers, bit-exact to ``jax.random``.

The serving path's randomness contract (shared uniforms between drafter
and verifier, per-request ``fold_in(fold_in(key, uid), blocks)`` streams)
only holds across the two packages if the port draws the very same bits
as JAX.  This module reproduces ``jax.random`` as JAX 0.9.0 runs it with
``jax_threefry_partitionable=True`` and the ``threefry2x32`` impl:

* a key is a ``(..., 2)`` tensor of uint32 values;
* ``split(key, n)[i]`` hashes the 64-bit counter ``i`` (hi, lo words);
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
* ``random_bits(key, shape)`` hashes the row-major flat index of every
  element and XORs the two output words;
* ``uniform`` keeps the top 23 bits as a mantissa in [1, 2), subtracts
  1, scales to [minval, maxval) and clamps at ``minval``;
* ``exponential`` is ``-log1p(-u)``, ``normal`` is ``sqrt(2) *
  erf_inv(u)`` over ``u`` in [nextafter(-1, 0), 1), and ``randint``
  reduces two 32-bit streams modulo the span, as ``jax.random`` does.

uint32 arithmetic is held in int64 tensors and masked after every add
and shift, so the same code runs on the CPU and on the card as plain
tensor ops.  Keys may carry leading batch axes: every sampler broadcasts
one key per batch element, which is how ``jax.vmap`` over keys draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block hash (20 rounds), broadcasting its four
    uint32 operands held in int64 tensors.  Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.clone(), x1.clone()
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``
    (a negative seed wraps to its uint32 bit pattern, as JAX does)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def _words(key: torch.Tensor):
    if key.shape[-1] != 2 or key.dtype != torch.int64:
        raise ValueError("a key is a (..., 2) int64 tensor of uint32 words")
    return key[..., 0], key[..., 1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: mix a 32-bit integer into the key(s).
    ``data`` is an int or an integer tensor broadcastable to the key's
    batch shape."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words: (..., 2) keys -> (..., *shape)."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    lead = k1.dim()
    k1 = k1.reshape(k1.shape + (1,))
    k2 = k2.reshape(k2.shape + (1,))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    out = b1.bitwise_xor_(b2)
    return out.reshape(out.shape[:lead] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., 2) keys -> (..., *shape)
    floats in [minval, maxval), bit for bit."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # The range is formed in float32 on the host, as JAX forms it; the
    # scalars are exact in float32, so the device arithmetic matches and
    # no blocking host-to-device copy enters the round.
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low", float32)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: one key per row of
    ``logits`` (keys (..., 2), logits (..., N)) -> (...,) int64.  The
    uniform bits are exact; the two logs may differ from XLA's in the
    last ulp, so a draw can differ only at a Gumbel near-tie."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def exponential(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.exponential`` in float32: ``-log1p(-u)``.  The uniform
    bits are exact; torch's ``log1p`` may differ from XLA's in the last
    ulp, so the draws agree to rtol 2.4e-7."""
    return -torch.log1p(-uniform(key, shape))


# Giles' single-precision erf^-1 ("Approximating the erfinv function",
# GPU Computing Gems, 2011): the polynomial XLA evaluates for float32
# ``erf_inv``, one branch for w = -log1p(-x^2) < 5 and one beyond.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it (``torch.erfinv``
    is another approximation and differs on most inputs).  Each Horner
    step ``c + p * w`` is one fused multiply-add in XLA's float32 code;
    it is formed here in float64, where ``p * w`` is exact, and rounded
    back, which gives the fused result on every device.  ``±1`` maps to
    ``±inf``."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [(float(np.float32(a)), float(np.float32(b)))
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = torch.where(small, *coef[0])
    for a, b in coef[1:]:
        p = (torch.where(small, a, b).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with
    ``u`` uniform in [nextafter(-1, 0), 1).  The uniform bits are exact;
    ``log1p`` inside ``erf_inv`` may differ from XLA's by an ulp, so the
    draws agree to rtol 4e-7 (about 3 ulp)."""
    return _SQRT2_F32 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32, bit for bit: two 32-bit streams
    from ``split(key)`` reduced modulo ``span = maxval - minval`` through
    a multiplier formed in wrapping uint32 arithmetic, as JAX forms it.
    An empty range returns ``minval``, as JAX does."""
    minval, maxval = int(minval), int(maxval)
    if not -(1 << 31) <= minval <= maxval < (1 << 31):
        raise ValueError(f"randint range [{minval}, {maxval}) is not int32")
    span = max(maxval - minval, 1)
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    mult = (((1 << 16) % span) ** 2 & _MASK) % span
    offset = ((hi % span) * mult & _MASK) + lo % span
    return ((offset & _MASK) % span + minval).to(torch.int32)


def _loggamma_one(key: torch.Tensor, alpha: float) -> torch.Tensor:
    """One ``jax.random.loggamma`` draw (``_gamma_one`` in log space):
    Marsaglia and Tsang's rejection loop in float32 over the same key
    splits, a shape below 1 boosted by ``log(u) / alpha``."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=key.device)
    one, alpha_orig = f32(1.0), f32(alpha)
    boost = bool(alpha_orig >= one)
    a = alpha_orig if boost else alpha_orig + one
    d = a - f32(1.0 / 3.0)
    c = f32(1.0 / 3.0) / torch.sqrt(d)
    key, sub = split(key)
    x2, v3, u = f32(0.0), one, f32(2.0)
    while bool((u >= one - f32(0.0331) * (x2 * x2))
               & (torch.log(u) >= x2 * f32(0.5)
                  + d * ((one - v3) + torch.log(v3)))):
        key, x_key, u_key = split(key, 3)
        x, v = f32(0.0), f32(-1.0)
        while bool(v <= 0.0):
            x_key, s = split(x_key)
            x = normal(s, ())
            v = one + x * c
        x2, v3, u = x * x, (v * v) * v, uniform(u_key, ())
    log_boost = f32(0.0)
    if not boost:
        log_u = -exponential(sub, ())
        if bool(log_u != 0.0):
            log_boost = log_u * (one / alpha_orig)
    return (torch.log(d) + torch.log(v3)) + log_boost


def dirichlet(key: torch.Tensor, alpha: Sequence[float]) -> torch.Tensor:
    """``jax.random.dirichlet`` of one vector of concentrations: a
    log-gamma draw per entry from ``split(key, len(alpha))``, then the
    softmax.  The uniform bits are exact; ``log`` and ``erf_inv`` may
    differ from XLA's in the last ulp, so the draws agree to a few ulp
    unless a rejection test sits on its boundary."""
    keys = split(key, len(alpha))
    logs = torch.stack([_loggamma_one(k, a) for k, a in zip(keys, alpha)])
    e = torch.exp(logs - logs.max())
    return e / e.sum()
