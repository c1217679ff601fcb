"""Parameter conversion from the JAX package's layout.

``params_from_jax`` takes a JAX parameter pytree of any family as numpy
arrays -- stacked ``layers`` leaves with a leading layer axis (the
hybrid's ``units`` with a leading unit axis, its recurrent blocks with a
second, ``extra_rec`` with one; the vlm's ``units`` holding ``self``
blocks stacked over (unit, block) and one ``cross`` block per unit;
whisper's ``encoder``/``decoder`` stacks), matmul weights in ``(in,
out)`` layout, ``embed``/``lm_head`` at ``padded_vocab`` -- and returns
the port's parameter dict, so both packages compute the same function in
the tests.  The leaves may be numpy arrays or torch tensors (a
checkpoint that ``train/checkpoint.py`` read).  ``params_to_jax`` is the
inverse: it stacks the port's per-layer trees on the host into JAX's
layout, the tree that JAX's ``init_params`` makes, so that a checkpoint
the port writes loads in JAX.  ``vae_params_from_jax`` carries the beta-VAE
codec's tree (``compression/vae.py``: plain nested dicts, OIHW conv and
``(in, out)`` dense weights in both packages) leaf for leaf.  No JAX
import: the caller converts leaves with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _t(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _take(tree, idx, device):
    """The slice ``idx`` of every leaf of a (nested) dict of stacked
    arrays, as tensors on ``device``."""
    if isinstance(tree, dict):
        return {kk: _take(sub, idx, device) for kk, sub in tree.items()}
    return _t(tree[idx], device)


def _leading(tree, axis: int = 0) -> int:
    """The size of ``axis`` of a (nested) dict's first leaf."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[axis]


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


def _vlm(tree, device) -> dict:
    units = tree["units"]
    n_units, n_self = _leading(units["self"]), _leading(units["self"], 1)
    return {
        "embed": _t(tree["embed"], device),
        "units": [{"self": [_take(units["self"], (u, i), device)
                            for i in range(n_self)],
                   "cross": _take(units["cross"], u, device)}
                  for u in range(n_units)],
        "final_norm": {"scale": _t(tree["final_norm"]["scale"], device)},
        "lm_head": _t(tree["lm_head"], device),
    }


def _encdec(tree, device) -> dict:
    out = {k: _take(tree[k], (), device)
           for k in ("embed", "pos_dec", "enc_norm", "dec_norm")}
    for k in ("encoder", "decoder"):
        out[k] = [_take(tree[k], i, device) for i in range(_leading(tree[k]))]
    return out


def _layers(tree, device) -> dict:
    stacked = tree["layers"]
    return {
        "embed": _t(tree["embed"], device),
        "layers": [_take(stacked, i, device)
                   for i in range(_leading(stacked))],
        "final_norm": {"scale": _t(tree["final_norm"]["scale"], device)},
        "lm_head": _t(tree["lm_head"], device),
    }


def tree_family(tree: dict) -> str:
    """Which layout a JAX parameter tree has, by its keys: "encdec"
    (``encoder`` and ``decoder``), "vlm" (``units`` of ``self`` and
    ``cross``), "hybrid" (``units`` of ``rec`` and ``attn``) or "layers"
    (the dense, MoE and SSM families)."""
    if "encoder" in tree and "decoder" in tree:
        return "encdec"
    units = tree.get("units")
    if units is not None and {"self", "cross"} <= units.keys():
        return "vlm"
    if units is not None and {"rec", "attn"} <= units.keys():
        return "hybrid"
    if "layers" in tree:
        return "layers"
    raise ValueError(f"unknown parameter tree: keys {sorted(tree)}")


_CONVERT = {"encdec": _encdec, "vlm": _vlm, "hybrid": _hybrid,
            "layers": _layers}


def params_from_jax(tree: dict, device=None) -> dict:
    """The port's parameter dict on ``device`` (``None``: the card, or an
    error when there is none; the tests pass ``"cpu"``)."""
    return _CONVERT[tree_family(tree)](tree, resolve_device(device))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu")


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _host(tree)


def _stack(trees: list):
    """One tree whose leaves stack the leaves of ``trees`` (each a dict
    of tensors, or a tensor) on a new leading axis, on the host."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([_host(t) for t in trees])


def params_to_jax(params: dict) -> dict:
    """JAX's stacked parameter tree of the port's ``params`` (any family),
    as torch tensors on the host: the inverse of ``params_from_jax``, so
    ``params_from_jax(params_to_jax(p))`` is ``p`` bit for bit."""
    if "encoder" in params and "decoder" in params:
        out = {k: _host_tree(params[k])
               for k in ("embed", "pos_dec", "enc_norm", "dec_norm")}
        for k in ("encoder", "decoder"):
            out[k] = _stack(params[k])
        return out
    out = {k: _host_tree(params[k])
           for k in ("embed", "final_norm", "lm_head")}
    if "layers" in params:
        out["layers"] = _stack(params["layers"])
        return out
    units = params["units"]
    inner = "self" if "cross" in units[0] else "rec"
    outer = "cross" if inner == "self" else "attn"
    out["units"] = {inner: _stack([_stack(u[inner]) for u in units]),
                    outer: _stack([u[outer] for u in units])}
    if params.get("extra_rec"):
        out["extra_rec"] = _stack(params["extra_rec"])
    return out


def vae_params_from_jax(tree: dict, device=None) -> dict:
    """The VAE codec's nested dict of leaves as tensors on ``device``
    (``None``: the card)."""
    from repro_torch.optim import tree_map
    device = resolve_device(device)
    return tree_map(lambda a: _t(a, device), tree)
