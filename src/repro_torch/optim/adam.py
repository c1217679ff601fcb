"""Adam(W) with decoupled weight decay, global-norm clipping and LR
schedules -- the port's counterpart of ``repro/optim/adam.py``.

Functional, as JAX's is: ``adam_update`` returns new parameter and state
trees and leaves its inputs untouched.  A tree is a nested dict / list
of tensors (the port's parameter layout); the moments mirror it.  The
step counter is a 0-dim int32 tensor on the parameters' device, so the
schedule and the bias corrections run on the device with no host sync.

Constants are float32, as JAX forms them: a Python float in JAX code is
a float32 constant (``b1 ** t`` is the float32 power of float32(b1) at
``t = float32(step)``), and a division by a constant divides by a 0-dim
tensor on the operand's device (PyTorch's CUDA division by a host scalar
multiplies by its reciprocal instead, and ``scalar / tensor`` does so on
every device).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


def _f32(v: float) -> float:
    """A Python float rounded to float32, as JAX rounds its scalars."""
    return float(np.float32(v))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant as a 0-dim tensor on ``like``'s device."""
    return torch.full((), _f32(v), dtype=torch.float32, device=like.device)


def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a tree in ``jax.tree_util.tree_leaves`` order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


class AdamState(NamedTuple):
    step: torch.Tensor   # 0-dim int32
    mu: dict             # first moment (f32)
    nu: dict             # second moment (f32)


def adam_init(params) -> AdamState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros, nu=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared sum, the leaves summed in
    order (``adam.py:25``)."""
    total = 0
    for g in tree_leaves(tree):
        g = g.float()
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping) (``adam.py:31``)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_const(max_norm, norm)
                       / torch.clamp(norm, min=_f32(1e-9)), max=1.0)


def adam_update(
    params,
    grads,
    state: AdamState,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
):
    """One AdamW step (``adam.py:37``).  Returns (new_params, new_state,
    metrics); ``lr`` is a Python float or a 0-dim float32 tensor.  The
    clip's scale multiplies each leaf inside the update, the product
    ``clip_by_global_norm`` forms, so no clipped copy of the gradient
    tree is alive beside the new parameters and moments (a 2.14e9-
    parameter float32 tree is 8 GiB)."""
    gnorm = global_norm(grads)
    scale = (None if max_grad_norm is None
             else _clip_scale(gnorm, max_grad_norm))
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(_f32(b1), t)
    bc2 = 1.0 - torch.pow(_f32(b2), t)
    if not isinstance(lr, torch.Tensor):
        lr = _f32(lr)
    c1, c1m = _f32(b1), _f32(1 - b1)
    c2, c2m = _f32(b2), _f32(1 - b2)
    eps, wd = _f32(eps), _f32(weight_decay)

    def upd(p, g, m, v):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m_new = c1 * m + c1m * g32
        v_new = c2 * v + c2m * g32 * g32
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if weight_decay:
            update = update + wd * p.float()
        return (p.float() - lr * update).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return (_pick(out, 0), AdamState(step, _pick(out, 1), _pick(out, 2)),
            {"grad_norm": gnorm})


def _pick(tree, i: int):
    """The i-th member of every (param, mu, nu) triple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    """lr(step) falling from ``base_lr`` to ``min_frac * base_lr`` over
    ``total_steps`` along a half cosine (``adam.py:78``); ``step`` is an
    integer tensor, the result a float32 tensor on its device."""
    def lr(step):
        step = torch.as_tensor(step)
        frac = torch.clamp(step.float() / _const(max(total_steps, 1), step),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
        return _f32(base_lr) * (_f32(min_frac) + _f32(1 - min_frac) * cos)
    return lr


def warmup_cosine_schedule(base_lr: float, warmup: int, total_steps: int,
                           min_frac: float = 0.1):
    """A linear warmup over ``warmup`` steps, then ``cosine_schedule``
    (``adam.py:86``).  Step 0 has lr 0."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = torch.as_tensor(step)
        w = torch.clamp(step.float() / _const(max(warmup, 1), step),
                        max=1.0)
        return torch.where(step < warmup, _f32(base_lr) * w,
                           cos(step - warmup))
    return lr
