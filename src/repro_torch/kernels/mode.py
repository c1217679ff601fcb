"""Kernel-or-plain resolution and launch accounting -- the port's
counterpart of the JAX package's ``kernels/pallas_mode.py``.

The JAX resolver is tri-state (compiled / interpret / jnp fallback) and
decides from the backend.  Here the tensor decides: a CUDA tensor
launches the hand-written kernel, a CPU tensor takes the kernel's plain
PyTorch version, anything else raises.  There is no fallback from
kernel to plain on a CUDA tensor: a kernel that fails to build or
launch raises.

``launch_counts`` counts kernel launches by name.  Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``chip_smoke.py`` resets the
counts before driving the server and reads them after).
"""

from __future__ import annotations

import collections
import functools

import torch

launch_counts: collections.Counter = collections.Counter()

# Thread-block clusters of up to this many blocks are portable across
# Hopper parts (cluster-split kernels: decode_attention, gls_row_race).
MAX_CLUSTER = 8
# Streaming multiprocessors of the H100 SXM, the port's card: the split
# plans' default when no device is named (the CPU tests).
H100_SMS = 132


def reset_launch_counts() -> None:
    launch_counts.clear()


def launch_name(kernel: str, head_dim: int, int8: bool = False) -> str:
    """The ``launch_counts`` key of an attention kernel's instance: the
    kernel's name, ``_int8`` for int8 K/V, and ``_d<D>`` for a head dim
    other than 64 (``decode_attention``, ``flash_attention_int8_d128``)."""
    name = kernel + ("_int8" if int8 else "")
    return name if head_dim == 64 else f"{name}_d{head_dim}"


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain route for device {t.device}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernels read rows
    with 16-byte loads and copies); a contiguous view at an odd offset is
    copied."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count

