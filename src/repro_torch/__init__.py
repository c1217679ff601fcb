"""PyTorch + CUDA port of the GLS speculative-decoding serving paths
(fused rounds over KV caches for dense models; the reference engine,
which serves Mamba-2), the GLS core and the Gaussian Wyner-Ziv
compression path.

A second package beside the JAX reference ``repro``: same module layout
(``core/``, ``compression/``, ``models/``, ``kernels/<name>/``,
``specdec/``, ``serving/``, ``launch/``, ``configs/``), PyTorch idiom
inside, and hand-written CUDA kernels for the Pallas kernels on those
paths (``kernels/gls_race``: the row, binned and joint races;
``kernels/decode_attention``, ``kernels/flash_attention``,
``kernels/ssd_chunk``).  It imports
``torch`` and ``numpy`` only -- never ``jax`` and nothing of ``repro``.

Precision policy: float32 matmuls run in full float32 everywhere.
Importing the package turns TF32 off for cuBLAS and cuDNN and pins
``torch.set_float32_matmul_precision("highest")``; with TF32 on, a
float32 matmul keeps about three decimal digits and the parity checks
against the JAX reference would test nothing.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
