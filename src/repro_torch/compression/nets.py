"""Small conv/MLP building blocks for the beta-VAE compression codec
(paper Table 7; consumed by ``compression/vae.py``) -- the port's
counterpart of ``repro/compression/nets.py``, NCHW activations and OIHW
conv weights as in the JAX package.

The ``*_params`` initializers draw with the port's ``random.normal``
from the same threefry key as JAX's, so a converted key gives JAX's
weights to the sampler's 1-3 ulp (``tests/test_torch_random.py``).  The
package turns cuDNN's TF32 off on import (``repro_torch/__init__.py``),
so the convolutions are float32 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as R


def _scale(v: float) -> float:
    """``jnp.sqrt(v)`` of a Python float: the float32 square root of
    float32(v)."""
    return float(np.sqrt(np.float32(v)))


def conv_params(key, c_in, c_out, k):
    w = R.normal(key, (c_out, c_in, k, k)) * _scale(2.0 / (c_in * k * k))
    return {"w": w, "b": torch.zeros((c_out,), dtype=torch.float32,
                                     device=key.device)}


def conv(p, x, stride=1, padding=1):
    """NCHW convolution with an OIHW weight, the bias added after
    (``nets.py:17``)."""
    y = F.conv2d(x, p["w"], stride=stride, padding=padding)
    return y + p["b"][None, :, None, None]


def upconv_params(key, c_in, c_out, k):
    return conv_params(key, c_in, c_out, k)


def upconv(p, x, padding=1):
    """2x nearest-neighbour upsample + conv (resize-conv, the standard
    checkerboard-free substitute for ConvTranspose2d; ``nets.py:29``)."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv(p, y, 1, padding)


def fc_params(key, d_in, d_out):
    w = R.normal(key, (d_in, d_out)) * _scale(1.0 / d_in)
    return {"w": w, "b": torch.zeros((d_out,), dtype=torch.float32,
                                     device=key.device)}


def fc(p, x):
    return x @ p["w"] + p["b"]
