"""``repro_torch.device.SyncCounter``: the engine's count of the host's
waits on the card (``draft_syncs``, ``host_syncs``).  On the CPU nothing
is waited for; on the card each synchronising operation counts once."""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.device import SyncCounter, to_device


def test_sync_counter_is_zero_on_cpu_and_passes_other_warnings():
    x = torch.arange(10)
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with SyncCounter(torch.device("cpu")) as c:
            x.sum().item()
            x.cpu().numpy()
            warnings.warn("unrelated")
    assert c.count == 0
    assert [str(w.message) for w in outer] == ["unrelated"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync counting watches the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_counter_counts_host_waits_on_card(cuda):
    x = torch.arange(10, device=cuda)
    with SyncCounter(cuda) as none:
        to_device(np.arange(4), cuda)        # non-blocking: no wait
        y = x * 2
    with SyncCounter(cuda) as three:
        y.sum().item()
        x.cpu()
        x[:3].cpu()
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with SyncCounter(cuda) as other:
            warnings.warn("unrelated")
    assert (none.count, three.count, other.count) == (0, 3, 0)
    assert [str(w.message) for w in outer] == ["unrelated"]
    assert torch.cuda.get_sync_debug_mode() == 0
