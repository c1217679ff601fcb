"""Multi-draft speculative decoding (paper Sec. 4, Algorithm 2) -- the
port's counterpart of ``repro/specdec/engine.py``: ``SpecDecConfig``,
``probs_from_logits``, ``block_randomness``, ``BlockOutcome``, the
reference engine ``SpecDecEngine`` and ``autoregressive_reference``.

``SpecDecEngine`` is stateless: every draft step and every block's
target scoring re-runs the registry's full-sequence ``forward`` over
fixed-size token buffers (causal models make the trailing buffer
harmless), the K drafts riding in the batch, R co-scheduled requests
stacked into (R*K, T) forwards.  Its K drafts may come from K distinct
drafters at per-drafter temperatures (``SpecDecConfig.draft_temps``, the
paper's diverse-drafts setup): each draft step then runs one forward per
drafter over its column of the buffers.  It serves any family the
registry has, so it is the port's serving path for Mamba-2 (the scheduler's
``cache_mode="reprefill"``): each forward of an SSM model launches the
``ssd_chunk`` kernel once per layer on the card.  Verification is the
fused block verifier (``block_verify.run_block_verify``), one host fetch
per request per block, or with ``verifier_backend="legacy"`` the
per-token host loop; each draft step fetches its K tokens per request
(``num_draft_syncs``), as in JAX.  All six strategies of JAX's engine
run; the rejection-sampling ones also keep the drafter's step
distributions for the verifier.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import random as R
from repro_torch.device import resolve_device, to_device
from repro_torch.models import forward
from repro_torch.specdec import verify as V
from repro_torch.specdec.block_verify import (
    BACKENDS,
    RS_STRATEGIES,
    run_block_verify,
)

STRATEGIES = ("gls", "gls_strong", "specinfer", "spectr", "single", "daliri")


@dataclasses.dataclass(frozen=True)
class SpecDecConfig:
    num_drafts: int = 8           # K
    draft_len: int = 4            # L
    strategy: str = "gls"
    target_temp: float = 1.0
    draft_temps: Optional[tuple] = None   # per-drafter; default all 1.0
    top_k: int = 50
    max_new_tokens: int = 64
    # "torch" (the JAX "xla" twin), "kernel" (the JAX "pallas" twin: the
    # gls_row_race CUDA kernel on the card) or "legacy" (the per-token
    # host loop; the reference engine only).
    verifier_backend: str = "torch"
    # Route the drafter's decode attention through the decode_attention
    # kernel / admission prefill through the flash_attention kernel.
    # On a CPU tensor each takes its kernel's plain version.
    decode_kernel: bool = False
    prefill_kernel: bool = False
    # Quantized serving (the cached engine only): int8 KV arenas with
    # per-vector scales, quantize-on-write, and W8A8 target matmuls in the
    # fused round's verify chunk.  Logits move within quantization
    # tolerance, so its gate is the acceptance rate, not the tokens.
    quant: bool = False
    # Paged KV arena (the cached engine only, ``engine.py:83-91``): the
    # pool stores KV in fixed-size pages behind a page table
    # (``models/paged.py``), so buffer growth widens the table, freed
    # requests return their pages, and the scheduler's v2 policy can
    # hold more requests than a fixed page budget covers at once.  The
    # contiguous pool is its token-stream oracle.
    paged: bool = False
    page_size: int = 64

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.verifier_backend not in BACKENDS:
            raise ValueError(
                f"unknown verifier backend {self.verifier_backend!r}")

    @property
    def temps(self) -> tuple:
        """The K drafters' temperatures (``engine.py:116-121``)."""
        if self.draft_temps is not None:
            assert len(self.draft_temps) == self.num_drafts
            return tuple(self.draft_temps)
        return (1.0,) * self.num_drafts


@dataclasses.dataclass
class GenerationStats:
    output: np.ndarray            # accepted token ids
    blocks: int                   # target model calls
    accepted_drafts: int          # accepted DRAFT tokens (excl. bonus)
    host_syncs: int = 0           # device->host transfers


class BlockOutcome(NamedTuple):
    """Host-side outcome of one speculative block for one request."""
    new_tokens: list              # emitted tokens (accepted + 1 of them)
    accepted: int                 # accepted draft tokens
    verify_syncs: int             # host transfers spent verifying
    active: np.ndarray            # (K,) final active mask


def probs_from_logits(logits: torch.Tensor, temp: float, top_k: int,
                      vocab_size: int) -> torch.Tensor:
    """Temperature + top-k filtered probabilities over the TRUE vocab:
    the padded-vocab logits are sliced to ``vocab_size`` first, the k-th
    largest value is the threshold (ties at it are kept), then softmax."""
    logits = logits[..., :vocab_size].float()
    if temp <= 0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, -1), vocab_size).float()
    logits = logits / temp
    if top_k and top_k < vocab_size:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full((), float("-inf"),
                                        dtype=logits.dtype,
                                        device=logits.device))
    return torch.softmax(logits, dim=-1)


def block_randomness(sub: torch.Tensor, draft_len: int, num_drafts: int,
                     vocab: int):
    """Shared log-uniforms + strategy key stream for one block, per key:
    sub (..., 2) -> (log_u (..., L+1, K, N), strat_keys (..., L+1, 2)).
    The uniforms are ``jax.random.uniform(minval=tiny, maxval=1)`` bit
    for bit; the log may differ from XLA's in the last ulp."""
    keys = R.split(sub)
    k_unif, k_strat = keys[..., 0, :], keys[..., 1, :]
    u = R.uniform(k_unif, (draft_len + 1, num_drafts, vocab),
                  minval=float(np.finfo(np.float32).tiny), maxval=1.0)
    return torch.log(u), R.split(k_strat, draft_len + 1)


def _check_device(params: dict, device: torch.device) -> None:
    if params["embed"].device.type != device.type:
        raise ValueError(f"parameters live on {params['embed'].device}, "
                         f"the engine on {device}")


class SpecDecEngine:
    """Speculative decoding over one target and K (possibly distinct)
    drafters sharing the target's vocabulary (``engine.py:186``), all
    ``(params, ModelConfig)`` pairs on ``device`` (``None`` = the card).
    ``drafters`` is one pair, or a list of one pair (drafting all K
    lanes) or of K pairs.  One pair at one temperature is the
    homogeneous case: a single forward a draft step over all R*K rows."""

    def __init__(self, target: tuple, drafters, cfg: SpecDecConfig,
                 device=None):
        self.device = resolve_device(device)
        self.t_params, self.t_cfg = target
        if isinstance(drafters, tuple):
            drafters = [drafters]
        drafters = list(drafters)
        if len(drafters) == 1:
            drafters = drafters * cfg.num_drafts
        if len(drafters) != cfg.num_drafts:
            raise ValueError(f"{len(drafters)} drafters for "
                             f"num_drafts={cfg.num_drafts}")
        self.drafters = drafters
        self._homogeneous = (all(d is drafters[0] for d in drafters)
                             and len(set(cfg.temps)) == 1)
        for params in [self.t_params] + [d[0] for d in drafters]:
            _check_device(params, self.device)
        self.cfg = cfg
        self.vocab = self.t_cfg.vocab_size
        # Serving instrumentation (read by the scheduler / chip_smoke).
        self.num_target_forwards = 0
        self.num_draft_forwards = 0
        # Device-to-host transfers of draft tokens (one per draft step).
        self.num_draft_syncs = 0

    def _buffer_forward(self, params, mcfg, bufs: np.ndarray):
        return forward(params, mcfg,
                       {"tokens": to_device(bufs.copy(), self.device)})

    # -- shared drafting / scoring core (R requests stacked) ---------------
    def _draft_block(self, log_u_all: torch.Tensor, bufs: np.ndarray,
                     p0s: np.ndarray):
        """Autoregressive draft loop over R stacked requests
        (``engine.py:258-309``).  log_u_all: (R, L+1, K, N) device; bufs:
        (R, K, T) host buffers (mutated in place); p0s: (R,) prefix
        lengths.  One drafter forward per step covers all R*K rows when
        the drafters are homogeneous; else one per drafter over its
        column of R rows, at its temperature (``engine.py:285-292``).
        Returns (draft_tokens (R, K, L) on the host, the drafter's step
        distributions (R, K, L, N) on the device for the
        rejection-sampling strategies, else None)."""
        cfg = self.cfg
        r_n, k_n, t_n = bufs.shape
        l_n, n = cfg.draft_len, self.vocab
        need_probs = cfg.strategy in RS_STRATEGIES
        d_tokens = np.zeros((r_n, k_n, l_n), np.int32)
        prob_steps = []
        rows = np.arange(k_n)
        row_idx = torch.arange(r_n * k_n, device=self.device)
        for j in range(l_n):
            pos = p0s + j - 1                                   # (R,)
            if self._homogeneous:
                params, mcfg = self.drafters[0]
                logits = self._buffer_forward(params, mcfg,
                                              bufs.reshape(r_n * k_n, t_n))
                self.num_draft_forwards += 1
                sel = logits[row_idx, to_device(np.repeat(pos, k_n),
                                                self.device)]
                p_all = probs_from_logits(sel, cfg.temps[0], cfg.top_k, n)
            else:
                cols = []
                for k, (params, mcfg) in enumerate(self.drafters):
                    logits = self._buffer_forward(params, mcfg, bufs[:, k])
                    self.num_draft_forwards += 1
                    sel = logits[row_idx[:r_n], to_device(pos,
                                                          self.device)]
                    cols.append(probs_from_logits(sel, cfg.temps[k],
                                                  cfg.top_k, n))
                p_all = torch.stack(cols, dim=1).reshape(r_n * k_n, n)
            toks = V.draft_token_from_uniforms(
                log_u_all[:, j].reshape(r_n * k_n, n), p_all)
            tk = toks.cpu().numpy().reshape(r_n, k_n)   # 1 transfer / step
            self.num_draft_syncs += 1
            d_tokens[:, :, j] = tk
            for r in range(r_n):
                bufs[r, rows, p0s[r] + j] = tk[r]
            if need_probs:
                prob_steps.append(p_all)
        d_probs = None
        if need_probs:
            d_probs = torch.stack(prob_steps, dim=1).reshape(r_n, k_n, l_n,
                                                             n)
        return d_tokens, d_probs

    def _score_block(self, bufs: np.ndarray, p0s: np.ndarray
                     ) -> torch.Tensor:
        """ONE target forward over all R*K stacked draft buffers; gathers
        q(. | X^(k)_{1:j}, c) at each request's L+1 scoring positions
        (``engine.py:336``).  Returns (R, K, L+1, N)."""
        cfg = self.cfg
        r_n, k_n, t_n = bufs.shape
        l_n = cfg.draft_len
        logits = self._buffer_forward(self.t_params, self.t_cfg,
                                      bufs.reshape(r_n * k_n, t_n))
        self.num_target_forwards += 1
        pos = np.stack([np.arange(p0 - 1, p0 + l_n) for p0 in p0s])
        rowpos = np.repeat(pos, k_n, axis=0)                # (R*K, L+1)
        sel = logits[torch.arange(r_n * k_n, device=self.device)[:, None],
                     to_device(rowpos, self.device)]
        q = probs_from_logits(sel, cfg.target_temp, cfg.top_k, self.vocab)
        return q.reshape(r_n, k_n, l_n + 1, self.vocab)

    # -- speculative blocks -------------------------------------------------
    def gen_blocks(self, subs: Sequence[torch.Tensor],
                   prefixes: Sequence[np.ndarray], buf_len: int) -> list:
        """Advance R requests by one speculative block each
        (``engine.py:352``): one batched draft loop, ONE target forward,
        one fused verification per request.  Per-request key streams
        (``subs``) are independent, so the result equals R sequential
        ``gen_block`` calls.  Returns a list of BlockOutcome."""
        cfg = self.cfg
        r_n, k_n = len(prefixes), cfg.num_drafts
        keys = torch.stack([torch.as_tensor(s).cpu() for s in subs])
        with record_function("block/randomness"):
            log_u_all, strat = block_randomness(
                keys.to(self.device), cfg.draft_len, k_n, self.vocab)
        p0s = np.asarray([len(p) for p in prefixes])
        bufs = np.zeros((r_n, k_n, buf_len), np.int32)
        for r, pre in enumerate(prefixes):
            bufs[r, :, :len(pre)] = pre
        with record_function("block/draft_sweep"):
            d_tokens, d_probs = self._draft_block(log_u_all, bufs, p0s)
        with record_function("block/target_forward"):
            q = self._score_block(bufs, p0s)
        outs = []
        # Verification per request (R fetches per round), as in JAX.
        with record_function("block/verify"):
            for r in range(r_n):
                hb = run_block_verify(
                    log_u_all[r], d_tokens[r],
                    None if d_probs is None else d_probs[r], q[r], strat[r],
                    strategy=cfg.strategy, backend=cfg.verifier_backend)
                outs.append(BlockOutcome(new_tokens=hb.new_tokens,
                                         accepted=hb.num_accepted,
                                         verify_syncs=hb.host_syncs,
                                         active=hb.active))
        return outs

    def gen_block(self, key: torch.Tensor, prefix: np.ndarray,
                  buf_len: int) -> BlockOutcome:
        """Single-request speculative block (the R = 1 case)."""
        return self.gen_blocks([key], [np.asarray(prefix, np.int32)],
                               buf_len)[0]

    # -- public API ---------------------------------------------------------
    def generate(self, key: torch.Tensor, prompt: np.ndarray,
                 max_new: Optional[int] = None) -> GenerationStats:
        """Blocks until ``max_new`` tokens, with JAX's key derivation
        (``key, sub = split(key)`` per block, ``engine.py:381``)."""
        max_new = max_new or self.cfg.max_new_tokens
        prefix = np.asarray(prompt, np.int32)
        buf_len = len(prefix) + max_new + self.cfg.draft_len + 2
        blocks = accepted = syncs = 0
        n0 = len(prefix)
        key = torch.as_tensor(key).cpu()
        while len(prefix) - n0 < max_new:
            key, sub = R.split(key)
            out = self.gen_block(sub, prefix, buf_len)
            prefix = np.concatenate(
                [prefix, np.asarray(out.new_tokens, np.int32)])
            blocks += 1
            accepted += out.accepted
            syncs += out.verify_syncs
        return GenerationStats(output=prefix[n0:n0 + max_new], blocks=blocks,
                               accepted_drafts=accepted, host_syncs=syncs)

    def serve(self, key: torch.Tensor, prompts: Sequence[np.ndarray],
              max_new: Optional[int] = None) -> list:
        """Each prompt generated on ``fold_in(key, i)`` (``engine.py:398``)."""
        key = torch.as_tensor(key).cpu()
        return [self.generate(R.fold_in(key, i), prompt, max_new)
                for i, prompt in enumerate(prompts)]


def autoregressive_reference(key: torch.Tensor, target: tuple,
                             prompt: np.ndarray, max_new: int,
                             temp: float = 1.0, top_k: int = 50,
                             use_gumbel_trace: bool = True,
                             device=None) -> np.ndarray:
    """Plain autoregressive sampling from the target (``engine.py:408``),
    the distribution speculative decoding must preserve.  With
    ``use_gumbel_trace`` each step is the Gumbel race of GLS with K = 1
    on ``uniform(sub, (V,))``, so sequences can be compared exactly
    under shared randomness; else a ``categorical`` draw.  One forward
    over the whole buffer per token; runs on ``device`` (``None`` = the
    card), where the target's parameters live."""
    device = resolve_device(device)
    params, mcfg = target
    _check_device(params, device)
    prefix = np.asarray(prompt, np.int32)
    buf = np.zeros((1, len(prefix) + max_new + 1), np.int32)
    buf[0, :len(prefix)] = prefix
    n = len(prefix)
    key = torch.as_tensor(key).cpu()
    tiny = float(np.finfo(np.float32).tiny)
    out = []
    for i in range(max_new):
        key, sub = R.split(key)
        logits = forward(params, mcfg, {"tokens": to_device(
            buf.copy(), device)})[0, n - 1 + i]
        probs = probs_from_logits(logits, temp, top_k, mcfg.vocab_size)
        sub = sub.to(device)
        if use_gumbel_trace:
            log_u = torch.log(R.uniform(sub, (mcfg.vocab_size,),
                                        minval=tiny, maxval=1.0))
            tok = int(V.gumbel_race_argmin(log_u, probs))
        else:
            tok = int(R.categorical(sub, torch.log(
                torch.clamp(probs, min=1e-30))))
        out.append(tok)
        buf[0, n + i] = tok
    return np.asarray(out, np.int32)
