"""Parameter conversion from the JAX package's layout.

``params_from_jax`` takes the JAX dense-family parameter pytree as numpy
arrays -- stacked ``layers`` leaves with a leading layer axis, matmul
weights in ``(in, out)`` layout, ``embed``/``lm_head`` at
``padded_vocab`` -- and returns the port's parameter dict, so both
packages compute the same function in the tests.  No JAX import: the
caller converts leaves with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    stacked = tree["layers"]
    n = np.asarray(stacked["attn_norm"]["scale"]).shape[0]

    def layer(i):
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

    return {
        "embed": _t(tree["embed"], device),
        "layers": [layer(i) for i in range(n)],
        "final_norm": {"scale": _t(tree["final_norm"]["scale"], device)},
        "lm_head": _t(tree["lm_head"], device),
    }
