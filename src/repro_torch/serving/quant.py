"""W8A8 int8 serving helpers -- the port's counterpart of
``repro/serving/quant.py``: per-output-channel int8 weights, per-token
int8 activations, and per-KV-vector int8 cache arenas.

Weights quantize symmetrically per output channel (max-abs / 127);
``qdot`` quantizes its activations per token the same way, multiplies
int8 by int8 and rescales in float32.  Only the large matmuls quantize
(attention projections, SwiGLU, the LM head); norms and embeddings stay
float32.  The KV arenas quantize separately, one scale per KV vector
(``quantize_kv``), and the attention kernels dequantize as they read.

All arithmetic is float32 in the JAX package's order: max-abs / 127,
``maximum(., 1e-8)``, round half to even, clip to +-127, so on the CPU
the quantized trees and KV leaves equal JAX's bit for bit.  (On the
card PyTorch divides by the Python scalar 127 as a multiply by its
reciprocal, so a scale may differ from the CPU's in its last bit.)

The integer product depends on the tensor's device:

* a CPU tensor takes JAX's CPU emulation (``quant.py:83-86``): the int8
  operands as float32 through one float32 matmul.  It is exact while the
  contraction depth K keeps ``K * 127^2 < 2^24`` (K <= 1040); past that
  (smollm-360m's ``w_down`` has K = d_ff = 2560) the float32 sum rounds,
  as JAX's own CPU path does, so the CPU tests compare like with like;
* a CUDA tensor takes an exact int8 x int8 -> int32 product,
  ``torch._int_mm`` (JAX's ``dot_general`` with
  ``preferred_element_type=int32`` on a GPU; JAX runs it outside any
  Pallas kernel, so a library call is the counterpart here).  It never
  falls back to the float32 route.  ``_int_mm`` takes more than 16 rows
  (fewer are zero-padded), K and N multiples of 8 (others raise) and
  its second operand column-major: ``quantize_weight`` stores a CUDA
  weight's int8 payload that way once, when the tree is quantized.
"""

from __future__ import annotations

import torch

_QNAMES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
# torch._int_mm on a CUDA tensor: more than this many rows, and K and N
# multiples of _INT_MM_MULTIPLE.
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def _symmetric_int8(x32: torch.Tensor, dim: int):
    """(int8 of ``x32``, float32 scale) with one scale per slice along
    ``dim`` (keepdim): max-abs / 127 floored at 1e-8."""
    scale = torch.amax(torch.abs(x32), dim=dim, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> dict:
    """(in, out) -> {"q": int8 (in, out), "s": f32 (out,)}, one scale per
    output channel.  On a CUDA tensor ``q`` is column-major (the layout
    ``torch._int_mm`` takes for its second operand); its values are the
    same."""
    q, scale = _symmetric_int8(w.float(), dim=-2)
    if q.is_cuda:
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    return {"q": q, "s": scale.squeeze(-2)}


def quantize_params(params: dict) -> dict:
    """A copy of a parameter tree with every matmul weight named in
    ``_QNAMES`` quantized by ``quantize_weight`` (the port's tree holds
    one (in, out) leaf per layer where JAX stacks (L, in, out) and
    quantizes per (L, out): the same numbers)."""

    def visit(name, leaf):
        if isinstance(leaf, dict):
            return {k: visit(k, v) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [visit(name, v) for v in leaf]
        if name in _QNAMES and leaf.dim() >= 2:
            return quantize_weight(leaf)
        return leaf

    return {k: visit(k, v) for k, v in params.items()}


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32 (M, N) on the card."""
    m, k = xq.shape
    n = wq.shape[1]
    if k % _INT_MM_MULTIPLE or n % _INT_MM_MULTIPLE:
        raise ValueError(
            f"qdot on the card: K = {k} and N = {n} must be multiples of "
            f"{_INT_MM_MULTIPLE} (torch._int_mm)")
    if m < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - m, k))])
    return torch._int_mm(xq, wq)[:m]


def qdot(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """W8A8 matmul: x (..., in) times {"q": int8 (in, out), "s": (out,)}
    -> (..., out) in x's dtype.  Activations quantize per token."""
    x32 = x.float()
    xq, sx = _symmetric_int8(x32, dim=-1)
    if x.is_cuda:
        lead = xq.shape[:-1]
        acc = _int_mm(xq.reshape(-1, xq.shape[-1]), wq["q"])
        acc = acc.reshape(*lead, -1).float()
    else:
        # Exact integers in float32; the sums stay exact for K <= 1040.
        acc = xq.float() @ wq["q"].float()
    out = acc * sx * wq["s"]
    return out.to(x.dtype)


def quantize_kv(x: torch.Tensor):
    """Per-KV-vector symmetric int8 over the trailing (head_dim) axis:
    x (..., D) -> (int8 (..., D), f32 scale (..., 1)).  The trailing-1
    scale keeps every arena op (row gather on axis 1, time growth on
    axis 3) shape-compatible with the int8 leaf."""
    return _symmetric_int8(x.float(), dim=-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 (..., D) * f32 (..., 1)."""
    return (q.float() * scale).to(dtype)


def verify_step_q(params_q: dict, cfg, tokens: torch.Tensor, cache: dict):
    """The int8 twin of ``transformer.verify_step`` (``quant.py:151``):
    the verify chunk with ``quantize_params``' tree, every quantized
    matmul a ``qdot``.  JAX spells out its block with ``_dense``,
    ``_project_qkv_q`` and ``_swiglu_q``; the port's layers dispatch on
    the weight (``layers.dense``), so ``verify_step`` runs the same
    products in the same order."""
    from repro_torch.models.transformer import verify_step
    return verify_step(params_q, cfg, tokens, cache)
