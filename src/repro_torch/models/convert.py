"""Parameter conversion from the JAX package's layout.

``params_from_jax`` takes a JAX parameter pytree of the dense, MoE, SSM
or hybrid family as numpy arrays -- stacked ``layers`` leaves with a
leading layer axis (the hybrid's ``units`` with a leading unit axis, its
recurrent blocks with a second, ``extra_rec`` with one), matmul weights
in ``(in, out)`` layout, ``embed``/``lm_head`` at ``padded_vocab`` --
and returns the port's parameter dict, so both packages compute the same
function in the tests.  No JAX import: the caller converts leaves with
``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _take(tree, idx, device):
    """The slice ``idx`` of every leaf of a (nested) dict of stacked
    arrays, as tensors on ``device``."""
    if isinstance(tree, dict):
        return {kk: _take(sub, idx, device) for kk, sub in tree.items()}
    return _t(np.asarray(tree)[idx], device)


def _leading(tree, axis: int = 0) -> int:
    """The size of ``axis`` of a (nested) dict's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[axis]


def _hybrid(tree, device) -> dict:
    units = tree["units"]
    n_units, n_rec = _leading(units["attn"]), _leading(units["rec"], 1)
    extra = tree.get("extra_rec")
    n_extra = 0 if extra is None else _leading(extra)
    return {
        "embed": _t(tree["embed"], device),
        "units": [{"rec": [_take(units["rec"], (u, r), device)
                           for r in range(n_rec)],
                   "attn": _take(units["attn"], u, device)}
                  for u in range(n_units)],
        "extra_rec": [_take(extra, e, device) for e in range(n_extra)],
        "final_norm": {"scale": _t(tree["final_norm"]["scale"], device)},
        "lm_head": _t(tree["lm_head"], device),
    }


def params_from_jax(tree: dict, device=None) -> dict:
    """The port's parameter dict on ``device`` (``None``: the card, or an
    error when there is none; the tests pass ``"cpu"``)."""
    device = resolve_device(device)
    if "units" in tree:
        return _hybrid(tree, device)
    stacked = tree["layers"]
    return {
        "embed": _t(tree["embed"], device),
        "layers": [_take(stacked, i, device)
                   for i in range(_leading(stacked))],
        "final_norm": {"scale": _t(tree["final_norm"]["scale"], device)},
        "lm_head": _t(tree["lm_head"], device),
    }
