"""Parameter conversion from the JAX package's layout.

``params_from_jax`` takes a JAX parameter pytree of the dense or the SSM
family as numpy arrays -- stacked ``layers`` leaves with a leading layer
axis, matmul weights in ``(in, out)`` layout, ``embed``/``lm_head`` at
``padded_vocab`` -- and returns the port's parameter dict, so both
packages compute the same function in the tests.  No JAX import: the
caller converts leaves with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# Per-layer leaves of the Mamba-2 block (``repro/models/mamba2.py:45``);
# the two norms are {"scale": ...} dicts.
_SSM_NORMS = ("norm", "y_norm")
_SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
               "out_proj")


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _dense_layer(stacked, i, device) -> dict:
    return {
        "attn_norm": {"scale": _t(np.asarray(
            stacked["attn_norm"]["scale"])[i], device)},
        "attn": {w: _t(np.asarray(stacked["attn"][w])[i], device)
                 for w in ("wq", "wk", "wv", "wo")},
        "mlp_norm": {"scale": _t(np.asarray(
            stacked["mlp_norm"]["scale"])[i], device)},
        "mlp": {w: _t(np.asarray(stacked["mlp"][w])[i], device)
                for w in ("w_gate", "w_up", "w_down")},
    }


def _ssm_layer(stacked, i, device) -> dict:
    out = {w: {"scale": _t(np.asarray(stacked[w]["scale"])[i], device)}
           for w in _SSM_NORMS}
    out.update({w: _t(np.asarray(stacked[w])[i], device)
                for w in _SSM_LEAVES})
    return out


def params_from_jax(tree: dict, device=None) -> dict:
    """The port's parameter dict on ``device`` (``None``: the card, or an
    error when there is none; the tests pass ``"cpu"``)."""
    device = resolve_device(device)
    stacked = tree["layers"]
    if "in_proj" in stacked:
        n = np.asarray(stacked["in_proj"]).shape[0]
        layer = _ssm_layer
    else:
        n = np.asarray(stacked["attn_norm"]["scale"]).shape[0]
        layer = _dense_layer
    return {
        "embed": _t(tree["embed"], device),
        "layers": [layer(stacked, i, device) for i in range(n)],
        "final_norm": {"scale": _t(tree["final_norm"]["scale"], device)},
        "lm_head": _t(tree["lm_head"], device),
    }
