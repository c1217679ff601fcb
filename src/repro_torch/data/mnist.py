"""Procedurally generated MNIST-like digits (28x28, values in [0,1]) --
the port's own copy of ``repro/data/mnist.py`` (numpy only; images and
splits are bit-identical to the JAX package's for the same seed).

MNIST itself is not available offline; we synthesize structurally similar
data — glyph bitmaps with random shift, thickness and pixel noise — so
the β-VAE compression pipeline (paper Sec. 5, Fig. 3/4) runs end-to-end.
"""

from __future__ import annotations

import numpy as np

# 7x5 bitmap font for digits 0-9.
_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph_array(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]], np.float32)


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    g = _glyph_array(digit)
    scale = rng.integers(2, 4)  # 2x or 3x upscaling
    up = np.kron(g, np.ones((scale, scale), np.float32))
    h, w = up.shape
    oy = rng.integers(2, 28 - h - 1)
    ox = rng.integers(2, 28 - w - 1)
    img[oy:oy + h, ox:ox + w] = up
    # Slight blur via box filter to soften edges.
    pad = np.pad(img, 1)
    img = (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:]
           + 4 * img) / 8.0
    img += rng.normal(0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def digits_dataset(n: int, seed: int = 0):
    """Returns (images (n,28,28), labels (n,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = np.stack([_render(int(d), rng) for d in labels])
    return images.astype(np.float32), labels.astype(np.int32)


def wz_split(images: np.ndarray, rng: np.random.Generator):
    """Paper Sec. 5.2 split: the RIGHT half (28x14) is the source; the side
    information is a random 7x7 crop from the LEFT half."""
    right = images[:, :, 14:]
    n = images.shape[0]
    oy = rng.integers(0, 21, n)
    ox = rng.integers(0, 7, n)
    crops = np.stack([images[i, oy[i]:oy[i] + 7, ox[i]:ox[i] + 7]
                      for i in range(n)])
    return right, crops
