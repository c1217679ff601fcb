"""Public wrapper of the SSD intra-chunk kernel and the chunked SSD around
it -- the port's counterpart of ``repro/kernels/ssd_chunk/ops.py``.

``ssd_chunk`` launches the CUDA kernel for a CUDA tensor and takes the
plain version for a CPU tensor (``kernels/mode.py``); it adds one to
``launch_counts["ssd_chunk"]`` where it launches the kernel.  It is a
``torch.autograd.Function``, so training differentiates through it: the
forward output on the card always comes from the kernel, and the
backward is the vector-Jacobian product of the same function, taken by
autograd through ``ssd_chunk_plain`` recomputed on the saved inputs
(torch ops).  The JAX package has no backward kernel to port: its
Pallas ``ssd_chunk`` has no ``custom_vjp``, and JAX trains Mamba-2
through the jnp ``ssd_chunked`` (``repro/models/mamba2.py:98``).
``ssd_chunked`` is the drop-in twin of ``models/mamba2.py::ssd_chunked``
(``ssd_chunked_kernel`` in the JAX package): the intra-chunk work in
``ssd_chunk``, the O(chunks) inter-chunk recurrence as a loop over
chunks (JAX's ``lax.scan``), then the inter-chunk output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mode import aligned16, launch_counts, use_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_plain


def _forward(x, dt, a, b_in, c_in):
    if not use_kernel(x):
        return ssd_chunk_plain(x, dt, a, b_in, c_in)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    y, states, total = ext.ssd_chunk(*(aligned16(t.float())
                                       for t in (x, dt, a, b_in, c_in)))
    launch_counts["ssd_chunk"] += 1
    return y, states, total


class _SSDChunk(torch.autograd.Function):
    """The kernel (or, on a CPU tensor, the plain version) forward; the
    backward recomputes ``ssd_chunk_plain`` on the saved inputs and
    takes its vector-Jacobian product with ``torch.autograd.grad``."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in):
        ctx.save_for_backward(x, dt, a, b_in, c_in)
        return _forward(x, dt, a, b_in, c_in)

    @staticmethod
    def backward(ctx, *grads_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return (None,) * len(inputs)
        with torch.enable_grad():
            outs = ssd_chunk_plain(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads_out)
                 if g is not None and o.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs],
                                         wanted, [g for _, g in pairs],
                                         allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor):
    """x: (B, NC, Q, H, P); dt: (B, NC, Q, H); a: (H,); b_in/c_in:
    (B, NC, Q, N), all f32 -> (y_intra (B, NC, Q, H, P), states
    (B, NC, H, P, N), total (B, NC, H)).  The two routes agree to float32
    summation order; the kernel is built for the Mamba-2 tile Q = 64,
    P = 64, N = 128 and rejects any other.  Differentiable: the
    backward is torch ops over the plain version (the module
    docstring)."""
    return _SSDChunk.apply(x, dt, a, b_in, c_in)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan (``mamba2.py:98``).

    x: (B, S, H, P); dt: (B, S, H) softplus'd f32; a: (H,) negative;
    b_in/c_in: (B, S, N) (shared by the heads, n_groups = 1); h0:
    optional initial state (B, H, P, N).  S is padded to a multiple of
    ``chunk`` with zeros (a zero step neither decays nor feeds the
    state).  Returns (y (B, S, H, P), h_final (B, H, P, N))."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = chunk
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = (s + pad) // q
    xs = x.reshape(bsz, nc, q, h, p)
    dts = dt.reshape(bsz, nc, q, h)
    bs = b_in.reshape(bsz, nc, q, n)
    cs = c_in.reshape(bsz, nc, q, n)

    y_intra, states, total = ssd_chunk(xs, dts, a, bs, cs)

    # Inter-chunk recurrence over chunk boundaries: the state entering
    # chunk c, then h <- h * exp(total_c) + state_c.
    h_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None else h0.float())
    h_ins = []
    for ci in range(nc):
        h_ins.append(h_prev)
        h_prev = (h_prev * torch.exp(total[:, ci])[:, :, None, None]
                  + states[:, ci])
    h_ins = torch.stack(h_ins, dim=1)                     # (B, NC, H, P, N)

    # Inter-chunk output: y_t += exp(cum_t) * C_t . h_in.
    cum = torch.cumsum(dts * a[None, None, None, :], dim=2)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cs.float(), h_ins,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), h_prev
