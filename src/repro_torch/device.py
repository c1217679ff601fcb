"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  With no card and no explicit CPU
request they raise: the port never falls back to the CPU silently.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card (``cuda``); anything else is taken as
    given.  A CUDA device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCounter:
    """Counts the host's waits on the card inside a ``with`` block.

    On a CUDA device it raises PyTorch's sync debug mode to "warn" for the
    block, so every operation that blocks the host on the stream (a
    blocking device-to-host or host-to-device copy, ``.item()``,
    ``nonzero``, ...) issues one warning, and counts those warnings;
    other warnings are passed on.  Explicit ``torch.cuda.synchronize``
    calls and the allocator's own waits are not seen.  On the CPU the
    host never waits on a device and the count stays 0."""

    def __init__(self, device: torch.device):
        self.device = device
        self.count = 0

    def __enter__(self) -> "SyncCounter":
        if self.device.type != "cuda":
            return self
        self._caught = warnings.catch_warnings(record=True)
        self._records = self._caught.__enter__()
        warnings.simplefilter("always")
        self._prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(max(self._prev, 1))
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type != "cuda":
            return
        torch.cuda.set_sync_debug_mode(self._prev)
        self._caught.__exit__(*exc)
        for w in self._records:
            if _SYNC_WARNING in str(w.message):
                self.count += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)


def to_device(arr, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` without a stream sync:
    a blocking host-to-device copy would wait for all queued device
    work, serialising the host with the round in flight."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)
