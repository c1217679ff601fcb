"""Training loop of the port -- the counterpart of
``repro/train/loop.py``: the LM loss (pad-vocab masking, a z-loss, the
MoE load-balance loss, chunked cross-entropy above a size), a train step
that closes over the loss, its autograd gradients and ``adam_update``,
and a host loop with logging.

JAX jits the step and donates the old parameters and optimizer state;
PyTorch runs it eagerly, and the functional update frees the old trees
when the caller drops them.  Each family's ``forward`` recomputes its
layers on the backward pass (``remat``, ``torch.utils.checkpoint``), as
JAX's ``scan_blocks`` does.  On the card Mamba-2's layers run the
``ssd_chunk`` kernel, forward and recomputation (its gradient:
``kernels/ssd_chunk/ops.py``); the attention families call the plain
attention, as JAX's training calls do.

With ``checkpoint_path`` the loop writes ``{"params": ...}`` at its end
in JAX's layout and byte format (``models/convert.py::params_to_jax``,
``train/checkpoint.py``), a file that JAX's ``load_checkpoint`` reads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.device import resolve_device, to_device
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_to_jax
from repro_torch.optim import (
    AdamState,
    adam_init,
    adam_update,
    tree_leaves,
    tree_map,
    warmup_cosine_schedule,
)
from repro_torch.train.checkpoint import save_checkpoint


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 300
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    log_every: int = 20
    z_loss: float = 1e-4      # logit-norm regularizer (stabilizes bf16)
    moe_aux_weight: float = 0.01


# Above this many (seq x padded_vocab) logit elements per batch row, the
# cross-entropy is computed in sequence chunks with rematerialization so
# the full (B, S, V) logits tensor is never alive at once
# (``loop.py:32-37``).
CHUNKED_CE_THRESHOLD = 1 << 24
CE_CHUNK = 512


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as XLA divides: by a 0-dim float32 tensor (a CUDA
    division by a host scalar multiplies by its reciprocal)."""
    return x / torch.full((), float(n), dtype=torch.float32,
                          device=x.device)


def _head_matrix(params, cfg: ModelConfig):
    """The output projection (d, Vpad) (``loop.py:40-43``): whisper's
    head is tied to its embedding, the other families have an
    ``lm_head``."""
    if cfg.family == "encdec":
        return params["embed"].T
    return params["lm_head"]


def _masked_ce_terms(logits, targets, vocab_size):
    """Returns (sum nll, sum logz^2) for one logits block: logits past
    ``vocab_size`` (the padding of ``padded_vocab``) are masked to the
    float32 minimum (``loop.py:46``)."""
    logits = logits.float()
    neg = torch.full((), torch.finfo(torch.float32).min,
                     dtype=torch.float32, device=logits.device)
    mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    logits = torch.where(mask, logits, neg)
    logz = torch.logsumexp(logits, dim=-1)
    tok = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum(logz - tok), torch.sum(logz * logz)


def chunked_ce(x, head, targets, vocab_size, chunk: int = CE_CHUNK):
    """Cross-entropy over sequence chunks (``loop.py:57``): logits (B, C,
    V) materialize one chunk at a time and are recomputed on the
    backward pass (``torch.utils.checkpoint`` per chunk).  x (B, S, d)
    the final normed hidden state; returns (mean nll, mean logz^2)."""
    b, s, _ = x.shape
    while s % chunk:
        chunk //= 2

    def terms(xc, tc):
        return _masked_ce_terms(xc @ head, tc, vocab_size)

    nll_sum = zz_sum = 0.0
    for c0 in range(0, s, chunk):
        nll_s, zz_s = L.remat(terms, True, x[:, c0:c0 + chunk],
                              targets[:, c0:c0 + chunk])
        nll_sum, zz_sum = nll_sum + nll_s, zz_sum + zz_s
    return _div(nll_sum, b * s), _div(zz_sum, b * s)


def lm_loss(params, cfg: ModelConfig, batch: dict, *,
            z_loss: float = 1e-4, moe_aux_weight: float = 0.01,
            remat: bool = True):
    """Next-token cross-entropy with pad-vocab masking, the z-loss and,
    for the MoE family, the load-balance loss (``loop.py:78``).  Large
    (S x V) uses ``chunked_ce`` over ``_head_matrix``.  The batch goes to
    the family's ``forward`` whole: encdec reads ``"frames"``, vlm
    ``"images"``.  Returns (loss, {"nll"})."""
    aux = 0.0
    s_dec = batch["targets"].shape[1]
    use_chunked = s_dec * cfg.padded_vocab > CHUNKED_CE_THRESHOLD
    if cfg.family == "moe":
        from repro_torch.models import moe
        out, aux = moe.forward(params, cfg, batch, remat=remat,
                               return_aux=True, return_hidden=use_chunked)
    else:
        out = registry.forward(params, cfg, batch, remat=remat,
                               return_hidden=use_chunked)
    tgt = batch["targets"]
    if use_chunked:
        nll, zz = chunked_ce(out, _head_matrix(params, cfg), tgt,
                             cfg.vocab_size)
    else:
        nll_sum, zz_sum = _masked_ce_terms(out, tgt, cfg.vocab_size)
        nll, zz = _div(nll_sum, tgt.numel()), _div(zz_sum, tgt.numel())
    loss = nll + z_loss * zz
    if cfg.family == "moe":
        loss = loss + moe_aux_weight * aux
    return loss, {"nll": nll}


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)`` over a
    tensor tree: ((loss, aux), grads), the grads a tree like
    ``params`` (zeros where a leaf does not reach the loss)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    loss, aux = loss_fn(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)}
    aux = tree_map(torch.Tensor.detach, aux)
    return (loss.detach(), aux), tree_map(lambda t: by_leaf[id(t)], p)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """The train step (``loop.py:107``): ``step(params, opt, batch) ->
    (params, opt, metrics)`` with the loss, its gradients, the lr of
    the warmup-cosine schedule at ``opt.step`` and one AdamW update.
    ``metrics`` holds 0-dim tensors ("loss", "lr", "nll",
    "grad_norm"): reading one waits for the device.  The two halves run
    under the profiler ranges ``train/loss_grad`` and ``train/adam``
    (``launch/profile_train.py``)."""
    lr_fn = warmup_cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)

    def step(params, opt: AdamState, batch):
        def loss_fn(p):
            return lm_loss(p, cfg, batch, z_loss=tcfg.z_loss,
                           moe_aux_weight=tcfg.moe_aux_weight)
        with record_function("train/loss_grad"):
            (loss, metrics), grads = value_and_grad(loss_fn, params)
        with record_function("train/adam"), torch.no_grad():
            lr = lr_fn(opt.step)
            params, opt, opt_metrics = adam_update(
                params, grads, opt, lr, weight_decay=tcfg.weight_decay,
                max_grad_norm=tcfg.max_grad_norm)
        return params, opt, {"loss": loss, "lr": lr, **metrics,
                             **opt_metrics}

    return step


def train(params, cfg: ModelConfig, tcfg: TrainConfig, dataset, *,
          checkpoint_path: Optional[str] = None, device=None, log=print):
    """Host training loop (``loop.py:134``) on the card unless
    ``device="cpu"``.  The parameters move to the device; batches come
    from ``dataset`` (numpy ``{"tokens", "targets"}``).  Every
    ``log_every`` steps and at the last the metrics come to the host.
    Returns (params, history), history a list of dicts with JAX's keys
    (loss, lr, nll, grad_norm, step, elapsed_s).  ``checkpoint_path``:
    the final parameters are saved there as JAX saves them
    (``loop.py:152-154``)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    opt = adam_init(params)
    step_fn = make_train_step(cfg, tcfg)
    history = []
    it = iter(dataset)
    t0 = time.time()
    for step in range(tcfg.total_steps):
        batch = {k: to_device(v, dev) for k, v in next(it).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = round(time.time() - t0, 1)
            history.append(m)
            log(f"step {step:4d} loss {m['loss']:.4f} "
                f"nll {m['nll']:.4f} lr {m['lr']:.2e}")
    if checkpoint_path:
        save_checkpoint(checkpoint_path, {"params": params_to_jax(params)})
    return params, history
