"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card; exits non-zero (printing no result) without one, or
when the port's sources are not beside this file.  Phases:

  1. environment: card name and power limit, torch/CUDA versions, the
     float32 precision flags; build the CUDA kernels from the sources
     (one ``load`` call, timed);
  2. kernels at the shapes of their paths: each CUDA kernel against its
     plain PyTorch version on the same inputs (the three races: exact,
     minima compared bit for bit; attention: max abs error <= 1e-4),
     timed with CUDA events (median of 25 samples of 10 back-to-back
     calls, after warm-up; 5 single calls for the slow plain binned
     race) beside its plain version.  ``decode_attention`` and
     ``gls_row_race`` (16-63 MB of inputs, most of which would stay in
     the 50 MB L2 cache between back-to-back calls) are timed the way
     the main path calls them: cycling through distinct input
     sets (one K/V set per drafter layer; for the race, three L2 caches
     of tables) so each call finds its inputs cold, and with ``device_ms``
     beside ``ms``, the kernel's own device time per launch from
     ``torch.profiler``; the decode check adds the edges of the kernel's
     split plan, the race check a tie across two splits and a minimum on
     a split's first element.  Each kernel also has one PyTorch library
     call as a
     yardstick the port never calls where one computes the kernel's
     function (none for the row and joint races: ``torch.min`` on a
     precomputed score is timed as a note only), and
     the bound (bytes over 3.35 TB/s or float32 operations over
     67 TFLOP/s, whichever is larger); for the flash and decode rows the
     products at float32 accuracy on the tensor cores (3 TF32 products per float32
     product, 2 for int8 K/V, at 495 TFLOP/s) or the bytes, whichever is
     larger, with the float32-FMA bound beside it as ``bound_fma_ms``.
     The int8 instances of both attention kernels (int8 K/V with
     per-vector float32 scales, the arenas of
     ``SpecDecConfig(quant=True)``) are held the same way
     against their plain versions at the serve shapes (decode also at
     its own split plan's and 256-key tiles' edges; the serve buffer
     T = 370 puts every other (row, head) scale row on an 8-byte
     boundary), with SDPA over the dequantized K/V (dequantized once,
     untimed) as the yardstick and the int8 bytes read as the bound.
     The tensor-core flash instances (int8 here, and the two of phase
     granite) and the decode's tensor-core group instance, float32 and
     int8 (phase giants, at the serve shape and over ``GIANT_LONG_T``
     keys), are also held to a float64 evaluation of the same inputs
     (int8 K/V dequantized there): the kernel's max error at most 4x the
     plain version's.  Each flash
     instance is also checked with ``causal=False`` against its plain
     version at the same inputs (1e-4; no served path passes it).
     The int8 decode and the joint race rows also give ``floor_ms``: the
     device time of the floor of their design (the same grid, clusters
     and data movement, no arithmetic; ``decode_attention_int8_floor``
     and ``gls_race_floor``, built with the extension), on the same
     inputs and plan;
  2b. reference: the cached kernel path (flash prefill, kernel decode)
     against one dense causal forward at full width, logits within 1e-3;
  3. serve: smollm-360m at its published widths (32-layer target, 4-layer
     drafter of the same widths, float32, weights drawn from the seed),
     4 slots x 8 drafts x 4 draft tokens, GLS with the kernel verifier and
     both attention kernels, 8 requests with prompts of 16-300 tokens
     (one past the largest admission bucket), 64 new tokens each; checks
     completion, token range, the host's waits on the card (none while a
     round or an admission is queued, one per round in the packed fetch)
     and that every kernel's launch count grew during the run;
  3q. quant serve: the phase 3 workload with ``SpecDecConfig(quant=True)``
     (int8 KV arenas, quantize-on-write, W8A8 verify through
     ``torch._int_mm``): the same completion, range and sync checks, the
     int8 decode and flash instances' launch counts and the row race's;
     tok/s, round wall, TTFT, peak device memory and the arena bytes of
     both phases are logged side by side;
  4. self-draft: drafter = target; with p = q the GLS coupling accepts
     every draft up to float near-ties, so the mean acceptance per block
     must reach 0.9 * L -- the end-to-end correctness check at full width.
     The sample is ``self_draft_units`` units (6 for smollm-360m, 3 for
     granite-8b: a standard error of at most 0.03 on the served quant
     rate), each 4 prompts of 64 tokens served at once with 48 new tokens
     a request, its own prompts and its own round key
     (``self_draft_unit``);
  4q. quant self-draft: the same units through the served quant path
     (int8 arenas and the W8A8 verify): the mean over the units of the
     acceptance rate (accepted / (blocks * L)) must reach the model's
     ``quant_rate_floor`` (its rate measured over 12 units less 3
     standard errors); its distance from the float32 rate is logged
     against the 0.2 tolerance of ``tests/test_quant_fused.py`` (over a
     sound sample it sits at or past that edge, on JAX's semantics:
     ROADMAP queue 3).  The units' sd and the mean's standard error are
     logged, and the rate of the 2-prompt sample the gate judged before
     it was widened (unit 0's requests 1 and 2);
  rs. the rejection-sampling baselines (SpecInfer, SpecTr, single-draft):
     ``block_verify_batched`` on the card against the CPU on the same
     tensors at (S, K, L, N) = (4, 8, 4, vocab), K = 1 for single (top-50
     p and q from random logits, drafts raced from the round's uniforms):
     equal tokens, accepted counts, active masks and bonus flags; the
     legacy host loop against the fused verifier for one block of each
     of the six strategies; then the phase 3 server with 4 requests of
     32 new tokens for gls, specinfer, spectr and single (K = 1):
     completion, token range, ``draft_syncs == 0``, ``host_syncs ==
     rounds``, decode and flash launches grew, ``gls_row_race`` launched
     once per round for gls and never for the others; tok/s, round wall,
     accepted per block, and from a traced window of 3 rounds of a second
     run the CUDA launches per round and ``round/block_verify``'s host and
     device ms; then the self-draft (drafter = target) per strategy:
     specinfer and single reach 0.9 L, spectr its bound for JAX's
     row-0 semantics (``phase_rs_self_draft``);
  kv: phase 3's workload through ``cache_mode="kv"`` (the host-driven
     round: L drafter sweeps fetching the drafts, one stacked verify
     chunk, per-request verification, the rollback gather, the catch-up
     only for slots that accepted every draft; the kernel routes on):
     per-uid streams equal to phase 3's, ``draft_syncs == L x rounds``,
     ``host_syncs`` and ``gls_row_race`` launches equal to the requests'
     blocks (one verification per advanced request a round), decode
     launches between L and L + 1 sweeps a round, flash launches as in
     phase 3; a shorter quant workload (4 requests x 16 tokens) through
     kv and kv_fused in turn, equal streams; then per-request admission
     (the dense ``prefill``, no flash launch) against bucketed under kv,
     4 requests x 16 tokens, equal streams.  tok/s, round wall and TTFT
     of each pair are logged side by side;
  paged: the paged KV arena and the v2 policy, every buffer pinned
     (``min_buf_len``) to the trace's largest requirement on every side
     of every comparison (the buffer sets the decode split plan, so the
     summation order).  First the paged decode and flash entry points
     against the contiguous kernels on the gathered view, bit for bit,
     at the serve's shapes (32 rows, T = 338, 256-query chunks), float32
     and int8, pages of PAGE_SIZE = 64 with some chains cut short; then
     phase 3's prompts, 8 requests x 32 tokens, on 4 slots: (a) the
     oracle, contiguous kv_fused FIFO; (b) paged kv_fused under v2 with
     ``preempt_tokens`` 8 over a fixed budget of twice the largest
     request's lifetime pages (page pressure, not slots, limits the live
     set): streams equal to (a), ``preemptions > 0``, ``draft_syncs ==
     0``, ``host_syncs == rounds``; (c) paged kv under v2 with JAX's
     eviction pattern (four requests run two steps, then a priority-5
     arrival evicts one, suspended into a handle and resumed): streams
     equal to (a), ``evictions >= 1``, ``evicted_s > 0``, ``draft_syncs
     == L x rounds``, ``host_syncs`` and ``gls_row_race`` launches = the
     requests' blocks, decode launches L x 4 drafter layers x rounds plus
     the catch-up sweeps; (d) quant, 4 x 16, paged kv_fused v2 (int8
     pages) against contiguous quant kv_fused: equal streams.  After
     each paged serve every slot and page is free.  tok/s, round wall
     and TTFT of (b) and (c) are logged against (a), with the peak
     device memory and the pool's pages x bytes a page against the
     contiguous arenas' bytes.  (e), granite-8b's, runs in phase
     granite;
  dense: smollm-360m's dense serving calls (``prefill`` of 90 tokens,
     ``decode_step``, a 10-token ``verify_step``) against one dense
     ``forward`` (1e-3), and ``forward`` over 2,560 tokens with chunked
     attention against the dense path (1e-4);
  diverse: heterogeneous drafters in the reference engine, the
     smollm-360m target through ``cache_mode="reprefill"``, K = 2, L = 5,
     target temperature 2.0, 4 requests x 8 tokens: gls and specinfer
     with draft temperatures (0.5, 1.0) and (1.0, 0.5), and gls with two
     distinct drafters (4 layers seed 1, 2 layers seed 2): K drafter
     forwards a draft step, ``gls_row_race`` launched once per request a
     block for gls and never for specinfer, block efficiency per request
     logged; then drafter invariance (the drafter against itself scaled
     by 1 + 1e-4, GLS, the same keys): equal outputs in at least 8 of 10
     generations;
  granite: granite-8b at its published widths (36 layers, d_model 4096,
     32 heads over 8 KV heads of head dim 128, d_ff 14,336; a 4-layer
     drafter of the same widths; weights from seeds 0 and 1; float32):
     the head-dim-128 instances of both attention kernels, float32 and
     int8 (``decode_attention_d128``, ``flash_attention_d128``,
     ``decode_attention_int8_d128``, ``flash_attention_int8_d128``),
     held to their plain versions within 1e-4 at granite's serve shapes
     as in phase 2 (decode q (32, 32, 128), k/v (32, 8, 370, 128), cold
     K/V sets, the split plan's edges, the 32/33/64/65-key tile edges
     and the int8 instance's 128-key ones, its floor; flash 256
     queries, where the tensor-core kernel and the plain version are also
     held to a float64 evaluation of the same inputs: the kernel's max
     error at most 4x the plain version's), timed beside the plain
     version, SDPA and the bound; phase 2b's reference check at 36
     layers; the phase 3
     server and its quant twin with 4 requests of 32 new tokens
     (completion, token range, the sync gates, the D = 128 instances'
     and the row race's launches), and the float32 serve again through
     ``cache_mode="kv"`` with phase kv's gates and streams equal to the
     kv_fused serve's; phase paged's (e): the paged entry points against
     the contiguous D = 128 kernels (bit for bit) and that kv workload
     again, paged, under v2, its buffer pinned to the one the contiguous
     kv serve reached, streams equal to it; phase 4's self-draft (>= 0.9 L) and
     phase 4q's two quant rates (the int8 arenas' held within 0.2 of
     float32's, the served quant path's logged).  The pair
     is freed before phase 5;
  5. compress: the Gaussian Wyner-Ziv experiment (``run_experiment``,
     backend "kernel") at the full compression shape -- 2048 trials in
     chunks of B = 512, N = 2^16 atoms, K = 4 decoders, l_max = 64 --
     with one ``gls_binned_race`` launch per chunk, every chunk's
     outputs equal to the sequenced "torch" backend on the same keys,
     the guard (``validate_wz_batch``) passing and the match rate held
     to its Prop.-4 bound; a small case against the JAX reference's
     recorded match rates; then the paper's Fig. 2 grid (N = 4096,
     2000 trials, K in {1, 2, 4}, l_max in {2, 8, 64}, GLS and the
     shared-sheet baseline): GLS equals the baseline at K = 1;
  6. gls: the joint race kernel ``gls_race`` against
     ``core.gls.gls_sample_heterogeneous`` on the same sheets (20 rows,
     K = 8, N = 49,152): equal draft and target selections;
  7. ssm: Mamba-2 through the reference engine.  ``gls_row_race``
     against its plain version at the reprefill verifier's shape (L + 1,
     K, vocab) = (5, 8, 50280), bitwise, as in phase 2; the ``ssd_chunk``
     kernel against its plain version at the serve shape (x (32, 4, 64, 32,
     64): 4 requests x 8 drafts, a 230-token buffer in 4 chunks of 64;
     atol = rtol = 5e-4 on y and the states, 1e-5 on the total, the
     tolerances of the JAX kernel test), both routes' error against a
     float64 reference logged, timed like the others; then
     mamba2-370m at its published widths (48 layers): the logits of one
     ``forward`` over 2 x 100 tokens (the kernel) against 100
     ``decode_step`` calls (the recurrence, no kernel) at every
     position, and against ``prefill`` of 99 tokens plus one
     ``decode_step`` (the kernel's chunk states carried into the cache),
     within 2e-3 (``tests/test_decode_consistency.py``); then serve it
     (48-layer target, 4-layer drafter of the same widths, weights from
     seeds 0 and 1) with ``SpecDecServer(cache_mode="reprefill")``
     (batched), GLS, K = 8, L = 4, top-k 50, the kernel verifier, 4
     requests with prompts of 64-192 tokens, 32 new tokens each (the
     workload of ``repro_torch.launch.profile_reprefill``): completion,
     token range, ``ssd_chunk`` launches equal to (4 L + 48) per round,
     ``gls_row_race`` launches equal to the requests' blocks; and the
     self-draft check (drafter = the 48-layer target, acceptance >=
     0.9 L).

Each of the paths of phases 3, 3q, rs, kv, paged, diverse, granite, 5, 6
and 7 is driven with the launch counts set to 0 just before it and read
just after; the ``kernels`` line reports each kernel's launches from its
own paths (``gls_row_race``: the sum over the float32 kv_fused serves of
smollm-360m and granite-8b, the kv serves, the paged serves, the gls
serves of phase diverse and the reprefill serve; ``decode_attention``
and ``flash_attention``: phase 3, the three rejection-sampling serves,
the float32 kv serves and paged (a)-(c); their int8 instances: phase
3q, the quant serves of phase kv and paged (d); the D = 128 instances:
granite's float32, quant, kv and paged kv serves).  The line before the last is a JSON object ``{"kernels":
[...]}``; the last line is ``{"ok": true, "device": {...}}``.  Every
phase failure is an exception, so the script exits non-zero after any
failure.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# Published H100 SXM peaks: HBM rate, the float32 rate outside the tensor
# cores (the port keeps f32 "highest") and the dense TF32 tensor-core rate
# (a float32-accurate product takes 3 TF32 products, ``flash_bound``).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# Its L2 cache: the cycled timings of the two small streaming kernels
# keep three times as many input bytes.
L2_BYTES = 50 * 2 ** 20

S_SLOTS, K_DRAFTS, L_DRAFT = 4, 8, 4
N_REQUESTS, MAX_NEW = 8, 64
# Phase rs: the serve of phase 3 cut to 4 requests of 32 new tokens per
# strategy; the self-draft runs 4 requests at once.
RS_REQUESTS, RS_MAX_NEW, RS_SELF_REQUESTS = 4, 32, 4
RS_STRATEGIES = ("specinfer", "spectr", "single")
# Phase kv: the quant workload through kv and kv_fused, per-request
# against bucketed admission; phase diverse: the reprefill serves of
# heterogeneous drafters.
KV_QUANT_REQUESTS, KV_QUANT_MAX_NEW = 4, 16
PR_REQUESTS, PR_MAX_NEW = 4, 16
# Phase paged: phase 3's prompts, 8 x 32 (a)-(c) and 4 x 16 quant (d), in
# pages of 64 tokens, preempt_tokens 8 under v2.
PAGED_REQUESTS, PAGED_MAX_NEW = 8, 32
PAGED_QUANT_REQUESTS, PAGED_QUANT_MAX_NEW = 4, 16
PAGE_SIZE, PAGED_PREEMPT = 64, 8
DIVERSE_REQUESTS, DIVERSE_MAX_NEW = 4, 8
PROMPT_MIN, PROMPT_MAX = 16, 300
SEED = 0

# The compression path at full size (DESIGN.md section 10.4's largest
# list) and the paper's Fig. 2 grid (examples/compress_gaussian.py).
WZ_SIGMA2 = 0.005
WZ_BATCH, WZ_ATOMS, WZ_K, WZ_LMAX, WZ_TRIALS = 512, 2 ** 16, 4, 64, 2048
GRID_ATOMS, GRID_TRIALS = 4096, 2000
# Phase 7 serves the reprefill workload of
# repro_torch.launch.profile_reprefill (model pair, K, L and traffic).
# tests/test_ssd_kernel.py: the kernel against its reference, and
# tests/test_decode_consistency.py: decode against forward.
SSD_TOL, SSD_TOL_TOTAL, SSM_LOGIT_TOL = 5e-4, 1e-5, 2e-3
# Phase giants: granite-34b (48 query heads over one KV head) and
# llama3-405b (16 per KV head) at their published widths, depth cut to
# (target, drafter) layers; kv_fused, 4 requests x 16 tokens, prompts of
# 16-64 tokens; granite-34b also through kv and with quant=True (on the
# kernel and the plain decode route).
GIANTS = (("granite-34b", 16, 2), ("llama3-405b", 2, 1))
GIANT_REQUESTS, GIANT_MAX_NEW, GIANT_PROMPTS = 4, 16, (16, 64)
# The giants' decode, float32 and int8, is also checked and timed over K/V
# of this many keys, every key live (a float32 set 134 MB for granite-34b,
# 1.07 GB for llama3-405b; int8 about a quarter).
GIANT_LONG_T = 4096
# Phases moe and hybrid: the reprefill workloads of
# repro_torch.launch.profile_reprefill.WORKLOADS; mixtral-8x22b's cached
# calls at 2 layers past its 4,096-key window (prefill, then decode
# steps, against a full-sequence forward), recurrentgemma-2b's at one
# unit (3 layers) past its 2,048-key window; both within SSM_LOGIT_TOL,
# tests/test_decode_consistency.py's tolerance.  mixtral's lengths,
# 4,166 and 4,174 = 2 x 2,083 and 2 x 2,087 tokens, route in groups of 2
# tokens (moe._group_size), as each decode step routes its one token:
# a group of at most 2 never overflows an expert's capacity (2), so the
# prefill, the steps and the forward keep every token.  In groups of
# many tokens they would drop different tokens by JAX's design (the
# forward's training capacity factor, other groups), not a port fault.
MIXTRAL_LAYERS, MIXTRAL_PREFILL, WINDOW_DECODES = 2, 4166, 8
HYBRID_PREFILL = 2100
# tests/test_quant_fused.py: the int8 acceptance rate against float32's.
QUANT_RATE_TOL = 0.2
# The served quant self-draft rate (int8 arenas and the W8A8 verify) over
# 12 independent units on the card (``tools/quant_self_draft_rate.py``,
# NVIDIA H100 80GB HBM3): per model the lowest mean and the largest sd a
# unit of the flash routes measured (kernel, plain, the parent's kernel).
# Phases 4 and 4q take enough units (``self_draft_unit``) that the mean's
# standard error is at most QUANT_SE_AIM, and hold the served rate to
# that mean less 3 standard errors: on JAX's semantics at these widths
# the rate sits at or past QUANT_RATE_TOL's edge (ROADMAP queue 3), so
# the tolerance's verdict is logged and this floor is what is held.
QUANT_RATE_READINGS = {"smollm-360m": (0.8143, 0.0714),
                       "granite-8b": (0.7617, 0.0458)}
QUANT_SE_AIM = 0.03
SELF_DRAFT_PROMPT, SELF_DRAFT_NEW = 64, 48
# tests/test_compression.py::test_gaussian_match_rate_meets_prop4_bound
# holds the match rate to its Prop.-4 bound less this allowance.
BOUND_ALLOWANCE = 0.05
# The JAX reference's run_experiment(PRNGKey(0), GaussianWZ(0.005, 2048),
# K=4, l_max=8, 200 trials) on the CPU: match_prob_any, match_prob_each.
JAX_SMALL_CASE = (0.79, 0.2)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, samples: int = 25, batch: int = 10, warmup: int = 3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def cold_sets(set_bytes: int, least: int = 4) -> int:
    """How many input sets to cycle through so that each call finds its
    inputs cold in L2: at least ``least``, and three L2 caches in all."""
    return max(least, -(-3 * L2_BYTES // set_bytes))


def time_cycled(calls, **kw):
    """``time_ms`` of ``calls`` (one closure per input set) taken in
    turn."""
    it = itertools.cycle(calls)
    return time_ms(lambda: next(it)(), **kw)


def device_ms(torch, calls, kernel: str, rounds: int = 10) -> float:
    """The kernel's own device time per launch over ``rounds`` passes
    through ``calls``: ``torch.profiler``'s ``key_averages()``, each
    kernel whose name holds ``kernel`` its device time over its count,
    summed over such kernels (a call that launches two).  Raises where
    the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):  # a first profile may miss the device activity
        for c in calls:
            c()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                for c in calls:
                    c()
            torch.cuda.synchronize()
        per_launch = sum(getattr(e, "device_time_total", 0.0) / e.count
                         for e in prof.key_averages()
                         if kernel in e.key and e.count)
        if per_launch > 0:
            return per_launch / 1e3
    raise AssertionError(f"torch.profiler shows no device time for {kernel}")


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log_kernel(kr: dict, smi: str) -> None:
    """One line per kernel check: error, kernel / plain / library / bound
    times (a race's ``torch.min`` time as a note: not its function)."""
    lib = ("none" if kr["library_ms"] is None
           else f"{kr['library_ms']:.4f} ms")
    note = f", note {kr['note_ms']:.4f} ms" if "note_ms" in kr else ""
    work = (f": {kr['flops']:.4g} flop, {kr['bytes']:.4g} bytes"
            if "flops" in kr else "")
    dev = (f" (device {kr['device_ms']:.4f} ms)" if "device_ms" in kr
           else "")
    floor = (f", floor {kr['floor_ms']:.4f} device ms (the design's grid "
             f"and data movement, no arithmetic)" if "floor_ms" in kr
             else "")
    fma = (f", float32-FMA bound {kr['bound_fma_ms']:.4f} ms"
           if "bound_fma_ms" in kr else "")
    log(f"kernel {kr['name']} [{kr['shape']}]: max_abs_err="
        f"{kr['max_abs_err']:.3g} kernel {kr['ms']:.4f} ms{dev}, plain "
        f"{kr['plain_ms']:.4f} ms, library {lib}{note} ({kr['library']}), "
        f"bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}{work}){fma}{floor} "
        f"[{smi}]")
    if "err64" in kr:
        a, b = kr["err64"]
        log(f"kernel {kr['name']} max abs err against float64: kernel "
            f"{a:.3g}, plain {b:.3g} (ratio "
            f"{a / b if b else float('inf'):.3g}, held to <= 4)")
    if "err_vs_float64" in kr:
        log(f"kernel {kr['name']} max abs err (y, states) against float64: "
            + ", ".join(f"{k} {v[0]:.3g}, {v[1]:.3g}"
                        for k, v in kr["err_vs_float64"].items()))


# ---------------------------------------------------------------------------
# Phase 2: kernels at the slice's shapes
# ---------------------------------------------------------------------------


def race_inputs(torch, dev, rows: int, vocab: int, n_sets: int, seed: int):
    """``n_sets`` race tables (log_s, log_q) of (rows, K, vocab): Gumbel
    race times and the top-50 verifier's log-probabilities."""
    from repro_torch.specdec.engine import probs_from_logits
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sets = []
    for _ in range(n_sets):
        u = torch.rand((rows, K_DRAFTS, vocab), generator=g,
                       device=dev).clamp_min(1e-30)
        q = probs_from_logits(torch.randn((rows, K_DRAFTS, vocab),
                                          generator=g, device=dev),
                              1.0, 50, vocab)
        sets.append((torch.log(-torch.log(u)),
                     torch.where(q > 0, torch.log(q.clamp_min(1e-30)),
                                 torch.tensor(float("-inf"), device=dev))))
    return sets


def time_race(torch, sets) -> dict:
    """``gls_row_race``, its plain version and ``torch.min`` on a
    precomputed score (a note), each cycling through ``sets``."""
    from repro_torch.kernels.gls_race.ops import gls_row_race
    from repro_torch.kernels.gls_race.ref import gls_row_race_plain
    inf = torch.tensor(float("inf"), device=sets[0][0].device)
    scores = [torch.where(torch.isfinite(lq), ls - lq, inf) for ls, lq in sets]
    calls = [lambda a=a: gls_row_race(*a) for a in sets]
    out = {"ms": time_cycled(calls),
           "device_ms": device_ms(torch, calls, "gls_row_race_kernel"),
           "plain_ms": time_cycled([lambda a=a: gls_row_race_plain(*a)
                                    for a in sets]),
           "note_ms": time_cycled([lambda s_=s_: torch.min(s_, dim=-1)
                                   for s_ in scores])}
    del scores
    return out


def kernel_race(torch, dev, rows: int, vocab: int):
    """``gls_row_race`` against its plain version at (rows, K, vocab):
    bitwise equal minima and argmins, with planted ties (one across two
    splits of the kernel's plan), a minimum on a split's first element, a
    +inf log_q and an all-dead row (``rows`` >= 4); timed on enough input
    sets to find each cold in L2."""
    from repro_torch.kernels.gls_race.ops import (gls_row_race,
                                                  row_race_split_plan)
    from repro_torch.kernels.gls_race.ref import gls_row_race_plain
    b, k, n = rows, K_DRAFTS, vocab
    n_sets = cold_sets(2 * b * k * n * 4)
    sets = race_inputs(torch, dev, b, vocab, n_sets, SEED)
    log_s, log_q = sets[0]
    splits, chunk = row_race_split_plan(b * k, n)
    assert splits > 1, (splits, chunk)
    # Exact ties (the lower index must win), one across the first split
    # boundary, the minimum on the second split's first element, a +inf
    # log_q (dead under the isfinite mask however small its score) and an
    # all-dead row.
    log_s[0, 0, :5] = -40.0
    log_q[0, 0, :5] = 0.0
    log_s[1, 0, [300, 100, 200]] = -40.0
    log_q[1, 0, [300, 100, 200]] = 0.0
    log_s[2, 0, 7] = -100.0
    log_q[2, 0, 7] = float("inf")
    log_q[3, 0] = float("-inf")
    log_s[0, 1, [chunk, chunk - 1]] = -40.0
    log_q[0, 1, [chunk, chunk - 1]] = 0.0
    log_s[1, 1, chunk] = -40.0
    log_q[1, 1, chunk] = 0.0
    rmin_k, rarg_k = gls_row_race(log_s, log_q)
    rmin_p, rarg_p = gls_row_race_plain(log_s, log_q)
    # The scalar-load path of the kernel (a row length not divisible by 4).
    odd_s, odd_q = log_s[..., 1:].contiguous(), log_q[..., 1:].contiguous()
    odd_k, odd_p = gls_row_race(odd_s, odd_q), gls_row_race_plain(odd_s,
                                                                  odd_q)
    torch.cuda.synchronize()
    assert torch.equal(rarg_k, rarg_p), "gls_row_race argmin != plain"
    assert torch.equal(rmin_k.view(torch.int32), rmin_p.view(torch.int32)), \
        "gls_row_race min != plain (bitwise)"
    assert int(rarg_k[0, 0]) == 0 and int(rarg_k[1, 0]) == 100
    assert int(rarg_k[3, 0]) == 0 and float(rmin_k[3, 0]) == float("inf")
    assert int(rarg_k[0, 1]) == chunk - 1, "cross-split tie: lower index"
    assert int(rarg_k[1, 1]) == chunk, "minimum on a split's first element"
    assert torch.equal(odd_k[0], odd_p[0]) and torch.equal(odd_k[1],
                                                           odd_p[1])
    err = float((rmin_k - rmin_p).abs().nan_to_num(0.0).max())
    nbytes = 2 * b * k * n * 4 + b * k * 8
    t_bound, by = bound(nbytes, 3 * b * k * n)
    return {
        "name": "gls_row_race", "route": "cuda",
        "source": "src/repro_torch/kernels/gls_race/row_race.cu",
        "replaces": "src/repro/kernels/gls_race/kernel.py:236",
        "shape": f"log_s/log_q ({b}, {k}, {n}) f32, {splits} splits of "
                 f"{chunk}, {n_sets} input sets (cold L2)",
        "max_abs_err": err,
        **time_race(torch, sets),
        "library_ms": None,
        "library": "none: no single call forms the masked score and its "
                   "argmin; torch.min(score, -1) on a precomputed score "
                   "(a note only) reads half the kernel's bytes, applies "
                   "no mask and is not the kernel's function",
        "bound_ms": t_bound, "bound_by": by,
    }


def _plant_binned(torch, log_s, log_q, bins, l_max):
    """Exact ties, an empty bin, a +inf weight, an all-dead row and a
    -0.0 minimum tied with a later +0.0 (as the CPU tests plant)."""
    lb = 1 % l_max
    bins[0][bins[0] == l_max - 1] = 0
    idx = torch.nonzero(bins[1] == lb).flatten()[:2]
    log_s[1, 0, idx] = -40.0
    log_q[1, 0, idx] = 0.0
    log_s[2, 1, 7] = -100.0
    log_q[2, 1, 7] = float("inf")
    log_q[3, -1] = float("-inf")
    in0 = torch.nonzero(bins[4] == 0).flatten()
    log_s[4, 2, in0] = 5.0
    log_q[4, 2, in0] = 0.0
    log_s[4, 2, in0[0]] = -0.0
    log_s[4, 2, in0[1]] = 0.0
    return int(idx[0]), int(in0[0])


def kernel_binned(torch, dev, l_max: int):
    """The binned race at the full compression shape: B trials, K
    decoders plus the encoder row, N atoms."""
    from repro_torch.kernels.gls_race.ops import gls_binned_race
    from repro_torch.kernels.gls_race.ref import gls_binned_race_plain
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10 + l_max)
    b, r, n = WZ_BATCH, WZ_K + 1, WZ_ATOMS
    log_s = torch.empty((b, r, n), device=dev).exponential_(
        generator=g).clamp_min(1e-38).log()
    log_q = torch.randn((b, r, n), generator=g, device=dev)
    log_q[torch.rand((b, r, n), generator=g, device=dev) < 0.2] = \
        float("-inf")
    bins = torch.randint(0, l_max, (b, n), generator=g, device=dev,
                         dtype=torch.int32)
    tie, neg0 = _plant_binned(torch, log_s, log_q, bins, l_max)
    bmin_k, barg_k = gls_binned_race(log_s, log_q, bins, l_max=l_max)
    bmin_p, barg_p = gls_binned_race_plain(log_s, log_q, bins, l_max=l_max)
    torch.cuda.synchronize()
    assert torch.equal(barg_k, barg_p), "gls_binned_race argmin != plain"
    assert torch.equal(bmin_k.view(torch.int32), bmin_p.view(torch.int32)), \
        "gls_binned_race min != plain (bitwise)"
    assert int(barg_k[1, 0, 1 % l_max]) == tie
    assert int(barg_k[4, 2, 0]) == neg0 and \
        bool(torch.signbit(bmin_k[4, 2, 0]))
    assert bool((bmin_k[3, -1] == float("inf")).all())
    assert bool((barg_k[3, -1] == 0).all())
    if l_max > 1:
        assert bool((bmin_k[0, :, -1] == float("inf")).all())
    err = float((bmin_k - bmin_p).abs().nan_to_num(0.0).max())
    score = torch.where(torch.isfinite(log_q), log_s - log_q,
                        torch.tensor(float("inf"), device=dev))
    index = bins[:, None, :].expand(b, r, n).long()
    base = torch.full((b, r, l_max), float("inf"), device=dev)
    nbytes = 2 * b * r * n * 4 + b * n * 4 + 2 * b * r * l_max * 4
    t_bound, by = bound(nbytes, 3 * b * r * n)
    return {
        "name": "gls_binned_race", "route": "cuda",
        "source": "src/repro_torch/kernels/gls_race/binned_race.cu",
        "replaces": "src/repro/kernels/gls_race/kernel.py:294",
        "shape": f"log_s/log_q ({b}, {r}, {n}) f32, bins ({b}, {n}) i32, "
                 f"l_max {l_max}",
        "max_abs_err": err,
        "ms": time_ms(lambda: gls_binned_race(log_s, log_q, bins,
                                              l_max=l_max)),
        "plain_ms": time_ms(lambda: gls_binned_race_plain(
            log_s, log_q, bins, l_max=l_max), samples=5, batch=1, warmup=1),
        "library_ms": time_ms(lambda: base.scatter_reduce(
            2, index, score, "amin")),
        "library": "scatter_reduce('amin') over (row, bin) of a precomputed "
                   "masked score: the minima only, no argmin",
        "bound_ms": t_bound, "bound_by": by,
    }


def joint_inputs(torch, dev, vocab: int):
    """The joint race's (log_s, log_p, log_q, active) at the serving race
    shape (S * (L + 1) rows of K drafts over the vocabulary), with exact
    ties (draft row (0, 0) and the target of row 0 across two drafts, whose
    blocks differ), a +inf weight, an all-dead draft row and a row with no
    active draft."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)
    b, k, n = S_SLOTS * (L_DRAFT + 1), K_DRAFTS, vocab
    u = torch.rand((b, k, n), generator=g, device=dev).clamp_min(1e-30)
    log_s = torch.log(-torch.log(u))
    log_p = torch.log_softmax(torch.randn((b, k, n), generator=g,
                                          device=dev), dim=-1)
    log_q = torch.log_softmax(torch.randn((b, k, n), generator=g,
                                          device=dev), dim=-1)
    for t in (log_p, log_q):
        t[torch.rand((b, k, n), generator=g, device=dev) < 0.3] = \
            float("-inf")
    active = torch.rand((b, k), generator=g, device=dev) < 0.7
    active[:, 0] = True
    # Exact ties (draft row (0, 0) and the target of row 0 across two
    # drafts), a +inf weight, an all-dead draft row, a row with no
    # active draft.
    log_s[0, :, [300, 100]] = -40.0
    log_p[0, 0, [300, 100]] = 0.0
    log_q[0, 0, 300] = 0.0
    log_q[0, -1, 100] = 0.0
    active[0, -1] = True
    log_s[1, 0, 7] = -100.0
    log_p[1, 0, 7] = float("inf")
    log_q[1, 0, 7] = float("inf")
    log_p[2, -1] = float("-inf")
    active[3] = False
    return log_s, log_p, log_q, active


def joint_bound(args):
    """The joint race's bound: log_s and log_p of every draft, log_q of
    the active ones (the target race is over active drafts only), the
    mask and x, y once."""
    log_s, _, _, active = args
    b, k, n = log_s.shape
    live = int(active.sum())
    return bound((2 * b * k + live) * n * 4 + b * k + (b * k + b) * 4,
                 (4 * b * k + 2 * live) * n)


def time_joint(torch, args) -> dict:
    """``gls_race`` (event and device time), its plain version, and
    ``torch.min`` on a precomputed draft score (a note)."""
    from repro_torch.kernels.gls_race.ops import gls_race
    from repro_torch.kernels.gls_race.ref import gls_race_plain
    log_s, log_p = args[:2]
    score = torch.where(torch.isfinite(log_p), log_s - log_p,
                        torch.tensor(float("inf"), device=log_s.device))
    calls = [lambda: gls_race(*args)]
    out = {"ms": time_ms(calls[0]),
           "device_ms": device_ms(torch, calls, "gls_race_kernel"),
           "plain_ms": time_ms(lambda: gls_race_plain(*args)),
           "note_ms": time_ms(lambda: torch.min(score, dim=-1))}
    del score
    return out


def kernel_joint(torch, dev, vocab: int):
    """The joint race at the serving race shape (``joint_inputs``),
    bitwise against its plain version; timed beside the floor of its
    design (the extension's ``gls_race_floor``) at the same plan."""
    from repro_torch.kernels.build import load_kernels
    from repro_torch.kernels.gls_race.ops import (gls_race,
                                                  joint_race_split_plan)
    from repro_torch.kernels.gls_race.ref import gls_race_plain
    args = joint_inputs(torch, dev, vocab)
    active = args[3]
    b, k, n = args[0].shape
    x_k, y_k = gls_race(*args)
    x_p, y_p = gls_race_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(x_k, x_p) and torch.equal(y_k, y_p), \
        "gls_race != plain"
    assert int(x_k[0, 0]) == 100 and int(y_k[0]) == 100
    assert int(x_k[1, 0]) != 7 and int(x_k[2, -1]) == 0 and int(y_k[3]) == 0
    t_bound, by = joint_bound(args)
    live = int(active.sum())
    kc = joint_race_split_plan(k)
    floor = load_kernels().gls_race_floor
    return {
        "name": "gls_race", "route": "cuda",
        "source": "src/repro_torch/kernels/gls_race/joint_race.cu",
        "replaces": "src/repro/kernels/gls_race/kernel.py:369",
        "shape": f"log_s/log_p/log_q ({b}, {k}, {n}) f32, active ({b}, {k}) "
                 f"with {live} active, {kc} drafts a block: "
                 f"{b * -(-k // kc)} blocks",
        "max_abs_err": 0.0,
        **time_joint(torch, args),
        "floor_ms": device_ms(torch, [lambda: floor(*args, kc)],
                              "gls_race_floor_kernel"),
        "library_ms": None,
        "library": "none: no single call forms the masked scores and their "
                   "argmins; torch.min(score, -1) on a precomputed draft "
                   "score (a note only) reads a third of the kernel's "
                   "bytes, runs no target race, applies no mask and is not "
                   "the kernel's function",
        "bound_ms": t_bound, "bound_by": by,
    }


def serve_kv_len(torch, dev, b: int, t: int, seed: int):
    """kv_len as the drafter sweep sees it: per slot a prompt of 16-300
    tokens, up to MAX_NEW generated and a draft step of 1..L + 1, shared
    by the slot's K draft rows; row 0 empty (kv_len 0), row 1 full (T)."""
    rng = np.random.default_rng(seed)
    slots = b // K_DRAFTS
    pos = (rng.integers(PROMPT_MIN, PROMPT_MAX + 1, slots)
           + rng.integers(0, MAX_NEW + 1, slots)
           + rng.integers(1, L_DRAFT + 2, slots))
    kv_len = np.minimum(np.repeat(pos, K_DRAFTS), t).astype(np.int32)
    kv_len[0], kv_len[1] = 0, t
    return torch.from_numpy(kv_len).to(dev)


def decode_inputs(torch, dev, b: int, h: int, hkv: int, d: int, t: int,
                  n_sets: int = 4, full: bool = False):
    """q and one (k, v) set per drafter layer (four of the serve arena's
    (b, hkv, t, d) f32: ~121 MB at the serve shape, more than the L2
    cache, so each call finds its K/V cold; ``n_sets`` where a set is
    smaller), kv_len as the serve draws it (``full``: every key live)."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    q = torch.randn((b, h, d), generator=g, device=dev)
    kv_sets = [(torch.randn((b, hkv, t, d), generator=g, device=dev),
                torch.randn((b, hkv, t, d), generator=g, device=dev))
               for _ in range(n_sets)]
    kv_len = (torch.full((b,), t, dtype=torch.int32, device=dev) if full
              else serve_kv_len(torch, dev, b, t, SEED + 1))
    return q, kv_sets, kv_len


def time_decode(torch, q, kv_sets, kv_len) -> dict:
    """``decode_attention``, its plain version and SDPA, each cycling
    through the layers' K/V sets as the drafter sweep does."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    t = kv_sets[0][0].shape[2]
    mask = (torch.arange(t, device=q.device)[None, :]
            < kv_len.clamp_min(1)[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    calls = [lambda k=k, v=v: decode_attention(q, k, v, kv_len)
             for k, v in kv_sets]
    # The G <= 8 instance (decode_attention_kernel) or the group instance
    # (decode_attention_group_kernel).
    return {"ms": time_cycled(calls),
            "device_ms": device_ms(torch, calls, "decode_attention_"),
            "plain_ms": time_cycled([
                lambda k=k, v=v: decode_attention_plain(q, k, v, kv_len)
                for k, v in kv_sets]),
            "library_ms": time_cycled([
                lambda k=k, v=v: F.scaled_dot_product_attention(
                    q4, k, v, attn_mask=mask, enable_gqa=True)
                for k, v in kv_sets])}


def decode_edges(torch, dev, b: int, t: int, d: int, splits: int,
                 chunk: int, int8: bool = False):
    """kv_len on the edges of the decode kernel's split plan (a range
    ending exactly on a split boundary, one key past it and one short,
    kv_len 0, 1 and T) and of its tiles (64/65 keys; at head dim 128,
    whose float32 tiles hold 32 keys, also 32/33; the int8 instance's
    tiles of 256 keys at D = 64 and 128 at D = 128: one key short of a
    tile, a tile, one past, and the same at two tiles where T allows),
    repeated over the b rows."""
    edges = [0, 1, t, chunk, 2 * chunk, chunk + 1, chunk - 1, t - 1,
             (splits - 1) * chunk, 17, 64, 65] + ([32, 33] if d == 128
                                                  else [])
    if int8:
        from repro_torch.kernels.decode_attention.ops import INT8_TILE_KEYS
        tile = INT8_TILE_KEYS[d]
        edges += [e for e in (tile - 1, tile, tile + 1, 2 * tile - 1,
                              2 * tile, 2 * tile + 1) if e <= t]
    edges = [min(max(e, 0), t) for e in edges]
    return torch.tensor(edges, dtype=torch.int32, device=dev).repeat(
        -(-b // len(edges)))[:b]


def decode_bound(b: int, h: int, hkv: int, d: int, keys: float,
                 int8: bool = False):
    """The bounds of one decode call over ``keys`` live keys (the sum of
    kv_len).  Bytes: q and out, kv_len, and each live key's K and V
    (int8: plus its two float32 scales) once, over 3.35 TB/s.
    ``bound_ms``, as ``flash_bound``'s, the larger of the bytes' time and
    the (head, key) products (4 D flops a pair) at float32 accuracy on
    the tensor cores: 3 TF32 products per float32 product (2 for int8
    K/V, exact in TF32) at 495 TFLOP/s.  ``bound_fma_ms``: the larger of
    the bytes' time and 4 D + 4 flops a pair (int8: 4 D + 6) at the
    float32 FMA rate.  Returns (bound_ms, bound_by, bound_fma_ms)."""
    pairs = h * keys
    if int8:
        nbytes = 4 * (2 * b * h * d + b) + 2 * hkv * keys * (d + 4)
        fma_flops = pairs * (4 * d + 6)
    else:
        nbytes = 4 * (2 * b * h * d + 2 * hkv * keys * d + b)
        fma_flops = pairs * (4 * d + 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tc = (2 if int8 else 3) * pairs * 4 * d / PEAK_TF32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")) \
        + (bound(nbytes, fma_flops)[0],)


def time_decode_int8(torch, q, sets, kv_len, kf, vf) -> dict:
    """The int8 instance, its plain version cycling through the K/V
    ``sets``, and SDPA on the first set dequantized (``kf``, ``vf``,
    untimed) as the yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    t = sets[0][0].shape[2]
    mask = (torch.arange(t, device=q.device)[None, :]
            < kv_len.clamp_min(1)[:, None].long())[:, None, None, :]
    calls = [lambda s_=s_: decode_attention(q, s_[0], s_[1], kv_len, s_[2],
                                            s_[3]) for s_ in sets]
    # The G <= 8 instance (decode_attention_kernel_int8) or the group
    # instance (decode_attention_group_kernel).
    return {"ms": time_cycled(calls),
            "device_ms": device_ms(torch, calls, "decode_attention_"),
            "plain_ms": time_cycled([
                lambda s_=s_: decode_attention_plain(q, s_[0], s_[1], kv_len,
                                                     s_[2], s_[3])
                for s_ in sets]),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kf, vf, attn_mask=mask, enable_gqa=True))}


def decode_float64(torch, q, k, v, kv_len, k_scale=None, v_scale=None):
    """One decode evaluated in float64 (int8 K/V dequantized there by
    ``k_scale``/``v_scale``), with the plain version's masked-row contract
    (``masked_softmax``)."""
    from repro_torch.kernels.flash_attention.ref import masked_softmax
    b, h, d = q.shape
    hkv, t = k.shape[1:3]
    k, v = k.double(), v.double()
    if k_scale is not None:
        k, v = k * k_scale.double(), v * v_scale.double()
    qr = q.double().reshape(b, hkv, h // hkv, d)
    s = torch.einsum("bhgd,bhtd->bhgt", qr, k) / d ** 0.5
    live = (torch.arange(t, device=q.device)[None, :]
            < kv_len.long()[:, None])[:, None, None, :]
    w = masked_softmax(s, live)
    return torch.einsum("bhgt,bhtd->bhgd", w, v).reshape(b, h, d)


def decode_err64(torch, q, k, v, kv_len, name: str, k_scale=None,
                 v_scale=None):
    """(kernel, plain) max abs error against ``decode_float64`` on one
    set: the group instance's TF32 products (3 a product, 2 over int8
    K/V) are held to 4x the plain version's error, the rule of the
    tensor-core flash."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    want = decode_float64(torch, q, k, v, kv_len, k_scale, v_scale)
    err64 = tuple(float((o.double() - want).abs().max()) for o in (
        decode_attention(q, k, v, kv_len, k_scale, v_scale),
        decode_attention_plain(q, k, v, kv_len, k_scale, v_scale)))
    assert err64[0] <= 4 * err64[1], \
        f"{name} error against float64 {err64[0]} > 4 x plain's {err64[1]}"
    return err64


def decode_floor_ms(torch, q, kv_sets, kv_len, splits: int,
                    chunk: int) -> float:
    """Device ms per launch of the group instance's floor (the
    extension's ``decode_attention_group_floor``: its grid, clusters,
    copies and merge, no arithmetic) at the plan, cycling through
    ``kv_sets``."""
    from repro_torch.kernels.build import load_kernels
    floor = load_kernels().decode_attention_group_floor
    kvl = kv_len.to(torch.int32)
    return device_ms(torch, [lambda k=k, v=v: floor(q, k, v, kvl, splits,
                                                    chunk)
                             for k, v in kv_sets], "decode_attention_group")


def kernel_decode(torch, dev, cfg, t: int, smi: str = "",
                  long_t: int = 0):
    """``decode_attention`` against its plain version at the serve shape,
    on the serve's kv_len and on the edges of the kernel's split plan and
    tiles (``decode_edges``); timed on cold K/V.  The instance is the
    config's head dim's and group's (``decode_attention`` at 64,
    ``decode_attention_d128`` at 128, ``..._g<G>`` for a group above 8,
    the group instance, timed beside its floor).  ``long_t``: also the
    same instance over K/V of ``long_t`` keys, every key live, checked on
    one set and timed on cold sets with its bound, logged on a line of
    its own."""
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_launch_name,
                                                          decode_split_plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, h, hkv, d = S_SLOTS * K_DRAFTS, cfg.num_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    group = h // hkv
    name = decode_launch_name(d, False, group)
    # The giants' sets are small (2.8-22 MB): enough of them for three L2
    # caches.
    q, kv_sets, kv_len = decode_inputs(
        torch, dev, b, h, hkv, d, t,
        4 if group <= 8 else cold_sets(8 * b * hkv * t * d))
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, group=group)
    edges = decode_edges(torch, dev, b, t, d, splits, chunk)
    err = 0.0
    k, v = kv_sets[0]
    for lens in (kv_len, edges):
        out_k = decode_attention(q, k, v, lens)
        out_p = decode_attention_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err = max(err, float((out_k - out_p).abs().max()))
        assert err <= 1e-4, f"decode_attention max abs err {err}"
        assert bool((out_k[lens == 0] == 0).all()), \
            "kv_len == 0 row is not zero"
    keys = float(kv_len.sum())
    t_bound, by, t_fma = decode_bound(b, h, hkv, d, keys)
    floor = ({"floor_ms": decode_floor_ms(torch, q, kv_sets, kv_len, splits,
                                          chunk),
              "err64": decode_err64(torch, q, k, v, kv_len, name)}
             if group > 8 else {})
    kr = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:83",
        "shape": f"q ({b}, {h}, {d}), k/v ({b}, {hkv}, {t}, {d}) f32, "
                 f"{splits} splits of {chunk} keys, {len(kv_sets)} K/V sets "
                 f"(cold L2), {int(keys)} live keys",
        "max_abs_err": err,
        **time_decode(torch, q, kv_sets, kv_len),
        **floor,
        "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa)",
        "bound_ms": t_bound, "bound_by": by, "bound_fma_ms": t_fma,
    }
    del q, kv_sets
    if long_t:
        log_kernel(kernel_decode_long(torch, dev, b, h, hkv, d, long_t,
                                      name), smi)
    return kr


def kernel_decode_long(torch, dev, b: int, h: int, hkv: int, d: int,
                       t: int, name: str) -> dict:
    """The float32 decode instance over K/V of ``t`` keys with every key
    live (cold sets worth three L2 caches, at least four): against plain
    on the first set, timed beside its floor, plain, SDPA and bound."""
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_split_plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    q, kv_sets, kv_len = decode_inputs(torch, dev, b, h, hkv, d, t,
                                       cold_sets(8 * b * hkv * t * d),
                                       full=True)
    group = h // hkv
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, group=group)
    err = float((decode_attention(q, *kv_sets[0], kv_len)
                 - decode_attention_plain(q, *kv_sets[0], kv_len)).abs()
                .max())
    assert err <= 1e-4, f"{name} at T = {t}: max abs err {err}"
    err64 = decode_err64(torch, q, *kv_sets[0], kv_len, f"{name} at T = {t}")
    t_bound, by, t_fma = decode_bound(b, h, hkv, d, float(b * t))
    kr = {"name": f"{name} at T = {t}", "max_abs_err": err, "err64": err64,
          "shape": f"q ({b}, {h}, {d}), k/v ({b}, {hkv}, {t}, {d}) f32, "
                   f"every key live, {splits} splits of {chunk} keys, "
                   f"{len(kv_sets)} K/V sets (cold L2)",
          **time_decode(torch, q, kv_sets, kv_len),
          "floor_ms": decode_floor_ms(torch, q, kv_sets, kv_len, splits,
                                      chunk),
          "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa)",
          "bound_ms": t_bound, "bound_by": by, "bound_fma_ms": t_fma}
    del q, kv_sets
    gc_collect(torch)
    return kr


def flash_inputs(torch, dev, b: int, h: int, hkv: int, d: int, s: int,
                 t: int, int8: bool = False):
    """The admission shape: q (b, h, s, d) against (b, hkv, t, d) K/V (int8:
    quantized per vector as the arenas are, ``int8_kv_sets``); half the
    arena rows are first chunks (offset 0), half second chunks at offset s
    whose bucket tails run past T (kv_len = offset + s).  Returns the
    wrapper's arguments (q, k, v, q_off, kv_len, k_scale, v_scale; no
    scales for float K/V) and the causal mask (b, s, t)."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + (13 if int8 else 2))
    q = torch.randn((b, h, s, d), generator=g, device=dev)
    if int8:
        sets, _ = int8_kv_sets(torch, dev, b, hkv, t, d, 1, SEED + 14)
        k, v, ks, vs = sets[0]
    else:
        k = torch.randn((b, hkv, t, d), generator=g, device=dev)
        v = torch.randn((b, hkv, t, d), generator=g, device=dev)
        ks = vs = None
    q_off = torch.zeros(b, dtype=torch.int32, device=dev)
    q_off[b // 2:] = s
    kv_len = q_off + s
    k_pos = torch.arange(t, device=dev)
    q_pos = q_off[:, None].long() + torch.arange(s, device=dev)
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < kv_len[:, None, None].long()))
    return (q, k, v, q_off, kv_len, ks, vs), mask


def flash_kv(torch, args, dtype):
    """K and V as ``dtype`` (int8: times their scales, in ``dtype``)."""
    _, k, v, _, _, ks, vs = args
    if ks is None:
        return k.to(dtype), v.to(dtype)
    return k.to(dtype) * ks.to(dtype), v.to(dtype) * vs.to(dtype)


def flash_float64(torch, args, mask):
    """The same attention evaluated in float64 (int8 K/V dequantized
    exactly), with the plain version's masked-row contract."""
    from repro_torch.kernels.flash_attention.ref import masked_softmax
    q = args[0].double()
    b, h, s, d = q.shape
    kf, vf = flash_kv(torch, args, torch.float64)
    hkv = kf.shape[1]
    qr = q.reshape(b, hkv, h // hkv, s, d)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qr, kf) / d ** 0.5
    w = masked_softmax(scores, mask[:, None, None])
    return torch.einsum("bhgst,bhtd->bhgsd", w, vf).reshape(b, h, s, d)


def flash_bound(h: int, hkv: int, d: int, mask, kv_len, t: int,
                int8: bool):
    """The bounds of one flash call.  Bytes: q and out once, each live
    key's K and V once (int8: one byte per element and a float scale per
    key and leaf), over 3.35 TB/s.  ``bound_ms``, the cheapest admissible
    design's, the larger of the bytes' time and the products of the
    unmasked (query, key) pairs (4 D flops a pair) at float32 accuracy on
    the tensor cores: 3 TF32 products per float32 product (2 for int8
    K/V, exact in TF32) at 495 TFLOP/s.  ``bound_fma_ms``, the SIMT
    design's (the D = 64 instances), the larger of the bytes' time and
    4 D + 4 flops a pair (int8 plus one multiply per dequantized element)
    at the float32 FMA rate.  Returns (bound_ms, bound_by, bound_fma_ms)."""
    import torch
    b, s = mask.shape[:2]
    pairs = float(mask.sum()) * h
    keys = float(torch.clamp(kv_len.long(), max=t).sum())
    if int8:
        nbytes = 4 * (2 * b * h * s * d + 2 * b) + 2 * hkv * keys * (d + 4)
        fma_flops = pairs * (4 * d + 4) + 2 * hkv * keys * d
    else:
        nbytes = 4 * (2 * b * h * s * d + 2 * hkv * keys * d + 2 * b)
        fma_flops = pairs * (4 * d + 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_tc = (2 if int8 else 3) * pairs * 4 * d / PEAK_TF32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")) \
        + (bound(nbytes, fma_flops)[0],)


def time_flash(torch, args, mask) -> dict:
    """The wrapper, its plain version and SDPA (on K/V dequantized once
    beforehand, untimed, for int8) on the same inputs; q and K/V (134 and
    97 MB at granite's shape) are read cold."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    q = args[0]
    kf, vf = flash_kv(torch, args, torch.float32)
    return {"ms": time_ms(lambda: flash_attention(*args)),
            "plain_ms": time_ms(lambda: flash_attention_plain(*args)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, kf, vf, attn_mask=mask[:, None], enable_gqa=True))}


def kernel_flash(torch, dev, cfg, s: int, t: int, int8: bool = False):
    """``flash_attention`` (the config's head dim's instance, float32 or
    int8 K/V) against its plain version at the admission shape, within
    1e-4, causal (the serve's) and, logged on a line of its own,
    ``causal=False`` (no served path passes it).  The tensor-core
    instances (D = 128, and int8 at D = 64) are also held to a float64
    evaluation of the same inputs: the kernel's error at most 4x the
    plain version's."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.mode import launch_name
    b, h, hkv, d = S_SLOTS * K_DRAFTS, cfg.num_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    name = launch_name("flash_attention", d, int8)
    args, mask = flash_inputs(torch, dev, b, h, hkv, d, s, t, int8)
    out_k = flash_attention(*args)
    out_p = flash_attention_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    assert err <= 1e-4, f"{name} max abs err {err}"
    rec = {}
    if d == 128 or int8:
        out64 = flash_float64(torch, args, mask)
        err64 = tuple(float((o.double() - out64).abs().max())
                      for o in (out_k, out_p))
        del out64
        assert err64[0] <= 4 * err64[1], \
            f"{name} error against float64 {err64[0]} > 4 x plain's {err64[1]}"
        rec["err64"] = err64
    del out_k, out_p
    err_nc = float((flash_attention(*args, causal=False)
                    - flash_attention_plain(*args, causal=False)).abs().max())
    log(f"kernel {name} causal=False against plain at the same inputs: max "
        f"abs err {err_nc:.3g} (tolerance 1e-4)")
    assert err_nc <= 1e-4, f"{name} causal=False max abs err {err_nc}"
    t_bound, by, t_fma = flash_bound(h, hkv, d, mask, args[4], t, int8)
    kv = (f"k/v ({b}, {hkv}, {t}, {d}) int8 + scales ({b}, {hkv}, {t}, 1) "
          f"f32" if int8 else f"k/v ({b}, {hkv}, {t}, {d}) f32")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:106",
        "shape": f"q ({b}, {h}, {s}, {d}) f32, {kv}",
        "max_abs_err": err,
        **rec,
        **time_flash(torch, args, mask),
        "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa)"
                   + (" on K/V dequantized once beforehand (untimed)"
                      if int8 else ""),
        "bound_ms": t_bound, "bound_by": by, "bound_fma_ms": t_fma,
    }


def int8_kv_sets(torch, dev, b: int, hkv: int, t: int, d: int, n: int,
                 seed: int):
    """``n`` int8 (k, v, k_scale, v_scale) sets, quantized per vector as
    the arenas are, and the dequantized (k, v) of the first set."""
    from repro_torch.serving.quant import dequantize_kv, quantize_kv
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sets = []
    for _ in range(n):
        (k8, ks), (v8, vs) = (quantize_kv(torch.randn(
            (b, hkv, t, d), generator=g, device=dev)) for _ in range(2))
        sets.append((k8, v8, ks, vs))
    k8, v8, ks, vs = sets[0]
    return sets, (dequantize_kv(k8, ks), dequantize_kv(v8, vs))


def decode_int8_inputs(torch, dev, b: int, h: int, hkv: int, d: int,
                       t: int, full: bool = False):
    """q, int8 K/V sets worth three L2 caches (``int8_kv_sets``), the
    first set dequantized, and the serve's kv_len draw (``full``: every
    key live)."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 11)
    q = torch.randn((b, h, d), generator=g, device=dev)
    n_sets = cold_sets(2 * b * hkv * t * (d + 4))
    sets, kvf = int8_kv_sets(torch, dev, b, hkv, t, d, n_sets, SEED + 12)
    kv_len = (torch.full((b,), t, dtype=torch.int32, device=dev) if full
              else serve_kv_len(torch, dev, b, t, SEED + 11))
    return q, sets, kvf, kv_len


def int8_floor_ms(torch, q, sets, kv_len, b: int, hkv: int, t: int,
                  group: int) -> float:
    """Device ms per launch of the floor of the int8 design at the
    wrapper's plan (the extension's ``decode_attention_int8_floor``: the
    G <= 8 instance's, or above 8 the group instance's, grid, clusters
    and data movement, no arithmetic), cycling through the K/V ``sets``."""
    from repro_torch.kernels.build import load_kernels
    from repro_torch.kernels.decode_attention.ops import (decode_group_plan,
                                                          decode_split_plan)
    d = q.shape[-1]
    if group > 8:
        slots, splits, chunk = decode_group_plan(b, hkv, t, head_dim=d,
                                                 group=group, int8=True)
    else:
        slots = 1
        splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, int8=True,
                                          group=group)
    floor = load_kernels().decode_attention_int8_floor
    kvl = kv_len.to(torch.int32)
    calls = [lambda s_=s_: floor(q, *s_, kvl, splits, chunk, slots)
             for s_ in sets]
    return device_ms(torch, calls, "decode_attention_group" if group > 8
                     else "decode_int8_floor_kernel")


def kernel_decode_int8(torch, dev, cfg, t: int, smi: str = "",
                       long_t: int = 0):
    """The int8 instance of ``decode_attention`` against its plain version
    at the serve shape: the serve's kv_len and the edges of its own split
    plan and tiles; timed on cold K/V (int8 sets worth three L2 caches)
    beside the floor of its design (``int8_floor_ms``) at the same plan.
    A group above 8 (the group instance) is also held to a float64
    evaluation of the dequantized attention (``decode_err64``) and, with
    ``long_t``, checked and timed over K/V of ``long_t`` keys, every key
    live, logged on a line of its own (``kernel_decode_int8_long``)."""
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_launch_name,
                                                          decode_split_plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, h, hkv, d = S_SLOTS * K_DRAFTS, cfg.num_heads, cfg.kv_heads, \
        cfg.resolved_head_dim
    group = h // hkv
    name = decode_launch_name(d, True, group)
    q, sets, (kf, vf), kv_len = decode_int8_inputs(torch, dev, b, h, hkv, d,
                                                   t)
    n_sets = len(sets)
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, int8=True,
                                      group=group)
    edges = decode_edges(torch, dev, b, t, d, splits, chunk, int8=True)
    # The serve buffers (T = 370, the giants' 86): the scale row of (b,
    # head) starts at (b Hkv + head) T * 4 bytes, 8-byte aligned only for
    # every odd row.
    assert (t * 4) % 16 != 0 and hkv * b > 1
    err = 0.0
    for lens in (kv_len, edges):
        out_k = decode_attention(q, *sets[0][:2], lens, *sets[0][2:])
        out_p = decode_attention_plain(q, *sets[0][:2], lens, *sets[0][2:])
        torch.cuda.synchronize()
        err = max(err, float((out_k - out_p).abs().max()))
        assert err <= 1e-4, f"{name} max abs err {err}"
        assert bool((out_k[lens == 0] == 0).all()), \
            "kv_len == 0 row is not zero"
    err64 = ({"err64": decode_err64(torch, q, *sets[0][:2], kv_len, name,
                                    *sets[0][2:])} if group > 8 else {})
    keys = float(kv_len.sum())
    t_bound, by, t_fma = decode_bound(b, h, hkv, d, keys, int8=True)
    kr = {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:83",
        "shape": f"q ({b}, {h}, {d}) f32, k/v ({b}, {hkv}, {t}, {d}) int8 "
                 f"+ scales ({b}, {hkv}, {t}, 1) f32, {splits} splits of "
                 f"{chunk} keys, {n_sets} K/V sets (cold L2), {int(keys)} "
                 f"live keys",
        "max_abs_err": err,
        **time_decode_int8(torch, q, sets, kv_len, kf, vf),
        "floor_ms": int8_floor_ms(torch, q, sets, kv_len, b, hkv, t, group),
        **err64,
        "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa) "
                   "on K/V dequantized once beforehand (untimed), one warm "
                   "set",
        "bound_ms": t_bound, "bound_by": by, "bound_fma_ms": t_fma,
    }
    del q, sets, kf, vf
    if long_t and group > 8:
        gc_collect(torch)
        log_kernel(kernel_decode_int8_long(torch, dev, b, h, hkv, d, long_t,
                                           name), smi)
    return kr


def kernel_decode_int8_long(torch, dev, b: int, h: int, hkv: int, d: int,
                            t: int, name: str) -> dict:
    """The int8 group instance over K/V of ``t`` keys with every key live
    (int8 sets worth three L2 caches): against plain and float64 on the
    first set, timed beside its floor, plain, SDPA on K/V dequantized
    beforehand and bound."""
    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_split_plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    q, sets, (kf, vf), kv_len = decode_int8_inputs(torch, dev, b, h, hkv, d,
                                                   t, full=True)
    group = h // hkv
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, int8=True,
                                      group=group)
    err = float((decode_attention(q, *sets[0][:2], kv_len, *sets[0][2:])
                 - decode_attention_plain(q, *sets[0][:2], kv_len,
                                          *sets[0][2:])).abs().max())
    assert err <= 1e-4, f"{name} at T = {t}: max abs err {err}"
    err64 = decode_err64(torch, q, *sets[0][:2], kv_len, f"{name} at T = {t}",
                         *sets[0][2:])
    t_bound, by, t_fma = decode_bound(b, h, hkv, d, float(b * t), int8=True)
    kr = {"name": f"{name} at T = {t}", "max_abs_err": err, "err64": err64,
          "shape": f"q ({b}, {h}, {d}) f32, k/v ({b}, {hkv}, {t}, {d}) int8 "
                   f"+ scales, every key live, {splits} splits of {chunk} "
                   f"keys, {len(sets)} K/V sets (cold L2)",
          **time_decode_int8(torch, q, sets, kv_len, kf, vf),
          "floor_ms": int8_floor_ms(torch, q, sets, kv_len, b, hkv, t,
                                    group),
          "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa) "
                     "on K/V dequantized once beforehand (untimed), one warm "
                     "set",
          "bound_ms": t_bound, "bound_by": by, "bound_fma_ms": t_fma}
    del q, sets, kf, vf
    gc_collect(torch)
    return kr


def phase_reference(torch, dev, target):
    """The cached kernel path against a plain forward at full width: two
    99-token prompts prefilled through ``prefill_slots`` (flash kernel)
    and one token decoded through ``decode_step_slots`` (decode kernel)
    must give the logits of one dense causal pass over all 100 tokens
    on a fresh cache (``verify_step_slots`` at position 0: no kernel, no
    cache reuse).  Tolerance 1e-3 absolute on logits of magnitude ~1:
    float32 summation order over 32 layers; TF32 matmuls (10-bit
    mantissa) would miss it by an order of magnitude."""
    from repro_torch.models import (decode_step_slots, init_cache,
                                    prefill_slots, verify_step_slots)
    params, cfg = target
    toks = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)).to(dev)
    cache = init_cache(cfg, 2, 128, dev)
    prefill_slots(params, cfg, toks[:, :99], cache, np.zeros(2, np.int64),
                  use_kernel=True)
    got = decode_step_slots(params, cfg, toks[:, 99:], cache,
                            torch.full((2,), 99, device=dev),
                            use_kernel=True)
    ref = verify_step_slots(params, cfg, toks, init_cache(cfg, 2, 128, dev),
                            torch.zeros(2, dtype=torch.int64,
                                        device=dev))[:, 99]
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"reference: cached kernel path vs dense forward, {cfg.num_layers} "
        f"layers: max abs logit err {err:.3g} (max |logit| {scale:.3g}, "
        f"tolerance 1e-3)")
    assert bool(torch.isfinite(got).all()), "non-finite logits"
    assert err <= 1e-3, f"cached path logits differ by {err}"
    return err


# ---------------------------------------------------------------------------
# Phases 3 and 4: serving at full width
# ---------------------------------------------------------------------------


def make_server(torch, dev, target, drafter, max_batch, quant=False,
                strategy="gls", cache_mode="kv_fused", admission="bucketed",
                decode_kernel=True):
    from repro_torch.specdec import CachedSpecDecEngine, SpecDecConfig
    from repro_torch.specdec import SpecDecServer
    k = 1 if strategy in ("single", "daliri") else K_DRAFTS
    cfg = SpecDecConfig(num_drafts=k, draft_len=L_DRAFT,
                        strategy=strategy, top_k=50, max_new_tokens=MAX_NEW,
                        verifier_backend="kernel",
                        decode_kernel=decode_kernel, prefill_kernel=True,
                        quant=quant)
    engine = CachedSpecDecEngine(target, drafter, cfg, pool_slots=S_SLOTS,
                                 device=dev)
    return engine, SpecDecServer(engine, max_batch=max_batch,
                                 cache_mode=cache_mode, admission=admission)


def phase_serve(torch, dev, target, drafter, quant=False,
                requests: int = N_REQUESTS, max_new: int = MAX_NEW,
                label: str = "serve", cache_mode: str = "kv_fused",
                admission: str = "bucketed",
                prompts: tuple = (PROMPT_MIN, PROMPT_MAX),
                decode_kernel: bool = True):
    """Phase 3 (float32 arenas) or 3q (``quant``: int8 arenas, W8A8
    verify; the attention kernels' int8 instances count under their own
    names), ``requests`` requests of ``max_new`` new tokens; the attention
    instances are those of the target's head dim (``launch_name``), and
    no other attention instance may launch.  ``cache_mode="kv"`` serves
    the same workload through the host-driven round, whose gates are
    its own: L draft fetches a round, one verify fetch and one
    ``gls_row_race`` launch per request a round, a catch-up sweep only
    in rounds where a slot accepted every draft; per-request admission
    prefills through the dense ``prefill`` (no flash launch, two
    dispatches a request).  ``prompts`` is the (shortest, longest)
    prompt length, the first prompt the longest;
    ``decode_kernel=False`` serves the drafter's decode attention on its
    plain route (no decode launch).  The stats carry the per-uid
    streams."""
    from repro_torch import random as R
    from repro_torch.kernels.decode_attention.ops import decode_launch_name
    from repro_torch.kernels.mode import (launch_counts, launch_name,
                                          reset_launch_counts)
    from repro_torch.launch.serve import draw_prompts
    vocab = target[1].vocab_size
    engine, server = make_server(torch, dev, target, drafter, S_SLOTS,
                                 quant=quant, cache_mode=cache_mode,
                                 admission=admission,
                                 decode_kernel=decode_kernel)
    p_min, p_max = prompts
    prompts = draw_prompts(requests, vocab, p_min, p_max, SEED)
    # One prompt of the longest length: at phase 3's, longer than the
    # largest admission bucket (256 at its buffer length), so admission
    # chunks.
    prompts[0] = np.random.default_rng(SEED + 7).integers(
        0, vocab, p_max).astype(np.int32)
    for p in prompts:
        server.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = server.run(R.PRNGKey(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    arena_mib = sum(leaf.numel() * leaf.element_size()
                    for arena in engine.pool.caches.values()
                    for leaf in arena.values()) / 2 ** 20
    m = server.metrics
    assert len(done) == requests, f"{len(done)}/{requests} finished"
    for r in done:
        out = np.asarray(r.output)
        assert len(out) == max_new, f"uid {r.uid}: {len(out)} tokens"
        assert out.min() >= 0 and out.max() < vocab, f"uid {r.uid} range"
    layers = target[1].num_layers + drafter[1].num_layers
    d_layers = drafter[1].num_layers
    dispatches = engine.num_prefill_dispatches
    d = target[1].resolved_head_dim
    group = target[1].num_heads // target[1].kv_heads
    decode = decode_launch_name(d, quant, group)
    flash = launch_name("flash_attention", d, quant)
    other = {launch_name(kernel, dd, qq)
             for kernel in ("decode_attention", "flash_attention")
             for dd in (64, 128) for qq in (False, True)} - {decode, flash}
    if not decode_kernel:
        assert decode not in counts, counts
        other.add(decode)
        decode = None
    # The host's waits on the card as the engine saw them (SyncCounter).
    if cache_mode == "kv_fused":
        # None while rounds and admissions are queued, one fetch a round.
        assert m.draft_syncs == 0, f"draft_syncs {m.draft_syncs}"
        assert m.host_syncs == m.rounds, (m.host_syncs, m.rounds)
        assert counts.get("gls_row_race", 0) >= m.rounds, counts
        assert decode is None or counts.get(decode, 0) >= \
            (L_DRAFT + 1) * d_layers * m.rounds, counts
    else:
        # L draft fetches a round; one verify fetch and one row race per
        # request a round (the requests' blocks).
        assert m.draft_syncs == L_DRAFT * m.rounds, (m.draft_syncs,
                                                     m.rounds)
        assert m.host_syncs == m.total_blocks, (m.host_syncs,
                                                m.total_blocks)
        assert counts.get("gls_row_race", 0) == m.total_blocks, counts
        assert decode is None or L_DRAFT * d_layers * m.rounds <= \
            counts.get(decode, 0) <= (L_DRAFT + 1) * d_layers * m.rounds, \
            counts
    if admission == "bucketed":
        assert counts.get(flash, 0) == layers * dispatches // 2, \
            (counts, dispatches)
    else:
        assert flash not in counts and dispatches == 2 * requests, \
            (counts, dispatches)
    assert not other & set(counts), counts
    be = m.mean_block_efficiency
    ttft = float(np.mean([r.ttft_ms for r in done]))
    name = f"{label} quant" if quant else label
    log(f"{name}: {len(done)} requests, {m.total_tokens} tokens in "
        f"{wall:.3f}s -> {m.total_tokens / wall:.1f} tok/s; rounds="
        f"{m.rounds} round wall {wall / m.rounds * 1e3:.1f} ms "
        f"block_efficiency={be:.3f} host_syncs={m.host_syncs} "
        f"draft_syncs={m.draft_syncs} prefill_dispatches={dispatches} "
        f"mean_ttft_ms={ttft:.1f} peak device memory {peak:.2f} GiB, "
        f"KV arenas {arena_mib:.1f} MiB launches={counts}")
    return counts, {"wall_s": wall, "tokens": m.total_tokens,
                    "rounds": m.rounds, "block_efficiency": be,
                    "tok_s": m.total_tokens / wall,
                    "round_ms": wall / m.rounds * 1e3, "ttft_ms": ttft,
                    "peak_gib": peak, "arena_mib": arena_mib,
                    "buf_len": server._buf_len,
                    "streams": {r.uid: list(r.output) for r in done}}


def same_streams(want: dict, got: dict, what: str) -> None:
    """Per-uid token streams must be equal; on a flip log and fail on
    the first diverging (uid, token)."""
    assert sorted(want) == sorted(got), (what, sorted(want), sorted(got))
    for uid in sorted(want):
        if want[uid] != got[uid]:
            i = next(i for i, (a, b) in enumerate(zip(want[uid], got[uid]))
                     if a != b)
            log(f"{what}: uid {uid} diverges at token {i}: "
                f"{want[uid][max(0, i - 2):i + 3]} vs "
                f"{got[uid][max(0, i - 2):i + 3]}")
            raise AssertionError(f"{what}: uid {uid} diverges at token {i}")
    log(f"{what}: {len(want)} streams equal "
        f"({sum(len(v) for v in want.values())} tokens)")


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def compare_serves(a: dict, b: dict, what: str, smi: str) -> None:
    log(f"{what} [{smi}]: "
        + ", ".join(f"{k} {a[k]:.4g} vs {b[k]:.4g}"
                    for k in ("tok_s", "round_ms", "ttft_ms", "rounds",
                              "block_efficiency")))


def phase_kv(torch, dev, target, drafter, fused_stats: dict, smi: str):
    """Phase kv: phase 3's workload through ``cache_mode="kv"`` (the
    host-driven round, bucketed admission, the kernel routes), its
    streams equal to phase 3's; a shorter quant workload through kv and
    kv_fused in turn, equal streams; per-request admission against
    bucketed under kv on a short float32 workload, equal streams.
    Returns the launch counts of the kv serves."""
    counts = {}
    c, kv = phase_serve(torch, dev, target, drafter, label="kv serve",
                        cache_mode="kv")
    add_counts(counts, c)
    same_streams(fused_stats["streams"], kv["streams"],
                 "kv vs kv_fused (phase 3's workload)")
    compare_serves(kv, fused_stats, "kv vs kv_fused serve", smi)
    gc_collect(torch)
    c, q_kv = phase_serve(torch, dev, target, drafter, quant=True,
                          requests=KV_QUANT_REQUESTS,
                          max_new=KV_QUANT_MAX_NEW, label="kv serve",
                          cache_mode="kv")
    add_counts(counts, c)
    gc_collect(torch)
    c, q_fused = phase_serve(torch, dev, target, drafter, quant=True,
                             requests=KV_QUANT_REQUESTS,
                             max_new=KV_QUANT_MAX_NEW,
                             label="kv_fused serve")
    add_counts(counts, c)
    same_streams(q_fused["streams"], q_kv["streams"], "quant kv vs kv_fused")
    compare_serves(q_kv, q_fused, "quant kv vs kv_fused serve", smi)
    gc_collect(torch)
    c, per_request = phase_serve(torch, dev, target, drafter,
                                 requests=PR_REQUESTS, max_new=PR_MAX_NEW,
                                 label="per-request kv serve",
                                 cache_mode="kv", admission="per_request")
    add_counts(counts, c)
    c, bucketed = phase_serve(torch, dev, target, drafter,
                              requests=PR_REQUESTS, max_new=PR_MAX_NEW,
                              label="bucketed kv serve", cache_mode="kv")
    add_counts(counts, c)
    same_streams(bucketed["streams"], per_request["streams"],
                 "per-request vs bucketed admission")
    compare_serves(per_request, bucketed,
                   "per-request vs bucketed admission (kv)", smi)
    gc_collect(torch)
    return counts


# ---------------------------------------------------------------------------
# Phase paged: the paged KV arena and the v2 policy
# ---------------------------------------------------------------------------


def check_paged_kernels(torch, dev, cfg, buf_len: int, smi: str) -> None:
    """The paged decode and flash entry points against the contiguous
    kernels on the gathered view, bit for bit, at the serve's shapes
    (S x K rows, the model's heads, ``buf_len`` keys, a 256-query
    prefill chunk), float32 and int8, in pages of PAGE_SIZE with three
    rows' chains cut short (unmapped tails)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_paged)
    from repro_torch.kernels.paged import gather_kv_pages
    from repro_torch.serving.quant import quantize_kv
    b, h, hkv = S_SLOTS * K_DRAFTS, cfg.num_heads, cfg.kv_heads
    d = cfg.resolved_head_dim
    n_lp = -(-buf_len // PAGE_SIZE)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 23)
    table = (torch.randperm(b * n_lp, generator=g, device=dev) + 1).reshape(
        b, n_lp)
    kv_len = serve_kv_len(torch, dev, b, buf_len, SEED + 23)
    kv_len[0] = 1
    for r in (2, 5, 9):
        cut = -(-int(kv_len[r]) // PAGE_SIZE)
        table[r, cut:] = 0
    shape = (b * n_lp + 1, hkv, PAGE_SIZE, d)
    pools = [torch.randn(shape, generator=g, device=dev) for _ in range(2)]
    for pool in pools:
        pool[0].zero_()
    q_dec = torch.randn((b, h, d), generator=g, device=dev)
    s = 256
    q_fl = torch.randn((b, h, s, d), generator=g, device=dev)
    off = torch.clamp(kv_len - s, min=0).to(torch.int32)
    for int8 in (False, True):
        if int8:
            (k8, ks), (v8, vs) = (quantize_kv(p) for p in pools)
            args = (k8, v8, ks, vs)
        else:
            args = (pools[0], pools[1], None, None)
        view = [None if x is None else gather_kv_pages(x, table, buf_len)
                for x in args]
        got = decode_attention_paged(q_dec, args[0], args[1], table, kv_len,
                                     args[2], args[3], buf_len=buf_len)
        want = decode_attention(q_dec, view[0], view[1], kv_len, view[2],
                                view[3])
        err_d = float((got - want).abs().max())
        assert torch.equal(got, want), ("paged decode", d, int8, err_d)
        got = flash_attention_paged(q_fl, args[0], args[1], table, off,
                                    kv_len, args[2], args[3],
                                    buf_len=buf_len)
        want = flash_attention(q_fl, view[0], view[1], off, kv_len, view[2],
                               view[3])
        err_f = float((got - want).abs().max())
        assert torch.equal(got, want), ("paged flash", d, int8, err_f)
        log(f"paged entry points [{smi}]: head dim {d} "
            f"{'int8' if int8 else 'float32'}, {b} rows x {n_lp} pages of "
            f"{PAGE_SIZE}, T = {buf_len}: decode and flash ({s} queries) "
            f"equal to the contiguous kernels on the gathered view bit for "
            f"bit (max abs diff {err_d}, {err_f})")


def paged_trace(vocab: int, n: int):
    """Phase 3's prompts: ``n`` of 16-300 tokens from the seed, the first
    of PROMPT_MAX tokens (past the largest admission bucket)."""
    from repro_torch.launch.serve import draw_prompts
    prompts = draw_prompts(n, vocab, PROMPT_MIN, PROMPT_MAX, SEED)
    prompts[0] = np.random.default_rng(SEED + 7).integers(
        0, vocab, PROMPT_MAX).astype(np.int32)
    return prompts


def page_bytes(pool) -> int:
    """Bytes of one physical page over every model and leaf."""
    return sum(leaf[:, 1].numel() * leaf.element_size()
               for pages in pool.pages.values() for leaf in pages.values())


def serve_run(torch, dev, target, drafter, prompts, max_new: int, label: str,
              *, quant=False, paged=False, cache_mode="kv_fused",
              policy="fifo", preempt=None, pool_pages=None, min_buf=0,
              pattern=None, max_batch=S_SLOTS):
    """Serve ``prompts`` (``max_new`` tokens each) through the cached
    engine on S_SLOTS slots (``max_batch`` of them live at once), GLS,
    K_DRAFTS x L_DRAFT, the kernel routes
    on, the buffer pinned to ``min_buf``; ``pattern(server, key)`` drives
    the submissions and returns the finished requests (default: submit
    all, run).  Checks completion and token range; returns the engine,
    the server and the stats (launch counts, streams, metrics, timing)."""
    from repro_torch import random as R
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    from repro_torch.specdec import (CachedSpecDecEngine, SpecDecConfig,
                                     SpecDecServer)
    vocab = target[1].vocab_size
    cfg = SpecDecConfig(num_drafts=K_DRAFTS, draft_len=L_DRAFT,
                        strategy="gls", top_k=50, max_new_tokens=max_new,
                        verifier_backend="kernel", decode_kernel=True,
                        prefill_kernel=True, quant=quant, paged=paged,
                        page_size=PAGE_SIZE)
    engine = CachedSpecDecEngine(target, drafter, cfg, pool_slots=S_SLOTS,
                                 pool_pages=pool_pages, device=dev)
    server = SpecDecServer(engine, max_batch=max_batch, cache_mode=cache_mode,
                           policy=policy, preempt_tokens=preempt,
                           min_buf_len=min_buf)
    key = R.PRNGKey(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    if pattern is None:
        for p in prompts:
            server.submit(p, max_new=max_new)
        done = server.run(key)
    else:
        done = pattern(server, key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    m = server.metrics
    assert len(done) == len(prompts), f"{label}: {len(done)} finished"
    for r in done:
        out = np.asarray(r.output)
        assert len(out) == max_new, f"{label}: uid {r.uid}: {len(out)}"
        assert out.min() >= 0 and out.max() < vocab, f"{label}: uid range"
    st = {"wall_s": wall, "tok_s": m.total_tokens / wall,
          "round_ms": wall / m.rounds * 1e3, "rounds": m.rounds,
          "ttft_ms": float(np.mean([r.ttft_ms for r in done])),
          "block_efficiency": m.mean_block_efficiency,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "counts": counts, "buf_len": server._buf_len,
          "streams": {r.uid: list(r.output) for r in done},
          "evicted_s": max(r.evicted_s for r in done)}
    log(f"{label}: {len(done)} requests x {max_new} tokens in {wall:.3f}s "
        f"-> {st['tok_s']:.1f} tok/s; rounds={m.rounds} round wall "
        f"{st['round_ms']:.1f} ms mean_ttft_ms={st['ttft_ms']:.1f} "
        f"block_efficiency={st['block_efficiency']:.3f} "
        f"host_syncs={m.host_syncs} draft_syncs={m.draft_syncs} "
        f"evictions={m.evictions} preemptions={m.preemptions} "
        f"max evicted_s={st['evicted_s']:.3f} buf_len={server._buf_len} "
        f"peak device memory {st['peak_gib']:.2f} GiB launches={counts}")
    return engine, server, st


def check_paged_end(engine, label: str) -> None:
    """Every slot and every page free once the trace has drained."""
    pool = engine.pool
    st = engine.page_state()
    assert pool.num_free == pool.num_slots, (label, pool.num_free)
    assert st["free"] == st["total"], (label, st)
    assert not pool.page_table.any(), label
    log(f"{label}: all {pool.num_slots} slots and {st['total']} pages free "
        f"at the end; view gathers {engine.num_view_gathers}, slot syncs "
        f"{engine.num_view_syncs}, refreshes {engine.num_view_refreshes}")


def eviction_pattern(n_first: int):
    """JAX's eviction pattern (``tests/test_scheduler.py:228-258``):
    the first ``n_first`` prompts run two steps, then the next arrives
    at priority 5, then the rest; returns the finished requests."""
    def pattern(server, key, prompts, max_new):
        for p in prompts[:n_first]:
            server.submit(p, max_new=max_new)
        done = server.step(key) + server.step(key)
        server.submit(prompts[n_first], max_new=max_new, priority=5)
        for p in prompts[n_first + 1:]:
            server.submit(p, max_new=max_new)
        return done + server.run(key)
    return pattern


def count_calls(obj, name: str) -> list:
    """Record the first argument of every call of ``obj.name``."""
    seen, orig = [], getattr(obj, name)

    def wrapped(*a, **kw):
        seen.append(a[0])
        return orig(*a, **kw)
    setattr(obj, name, wrapped)
    return seen


def phase_paged(torch, dev, target, drafter, smi: str):
    """Phase paged (module docstring).  Returns the launch counts of its
    serves."""
    vocab, d_layers = target[1].vocab_size, drafter[1].num_layers
    layers = target[1].num_layers + d_layers
    check_paged_kernels(torch, dev, target[1],
                        PROMPT_MAX + PAGED_MAX_NEW + L_DRAFT + 2, smi)
    prompts = paged_trace(vocab, PAGED_REQUESTS)
    min_buf = max(len(p) for p in prompts) + PAGED_MAX_NEW + L_DRAFT + 2
    counts = {}
    # (a) the oracle: contiguous kv_fused FIFO.
    eng_a, _, a = serve_run(torch, dev, target, drafter, prompts,
                            PAGED_MAX_NEW, "paged (a) contiguous kv_fused "
                            "fifo", min_buf=min_buf)
    arena_bytes = sum(leaf.numel() * leaf.element_size()
                      for arena in eng_a.pool.caches.values()
                      for leaf in arena.values())
    add_counts(counts, a["counts"])
    del eng_a
    gc_collect(torch)
    # (b) paged kv_fused v2 over a fixed budget of twice the largest
    # request's lifetime pages: page pressure, not slots, limits the set.
    need = max(-(-(len(p) + PAGED_MAX_NEW + L_DRAFT + 1) // PAGE_SIZE)
               for p in prompts) * K_DRAFTS
    budget = 2 * need
    eng_b, srv_b, b = serve_run(
        torch, dev, target, drafter, prompts, PAGED_MAX_NEW,
        "paged (b) paged kv_fused v2", paged=True, policy="v2",
        preempt=PAGED_PREEMPT, pool_pages=budget, min_buf=min_buf)
    same_streams(a["streams"], b["streams"], "paged (b) vs (a)")
    assert need == max(eng_b.request_pages(len(p) + PAGED_MAX_NEW)
                       for p in prompts)
    m = srv_b.metrics
    assert m.preemptions > 0, "paged (b): no preemption"
    assert m.draft_syncs == 0, f"paged (b): draft_syncs {m.draft_syncs}"
    assert m.host_syncs == m.rounds, (m.host_syncs, m.rounds)
    check_paged_end(eng_b, "paged (b)")
    pb = page_bytes(eng_b.pool)
    log(f"paged (b) memory [{smi}]: {eng_b.pool.num_pages} pages x {pb} "
        f"bytes = {eng_b.pool.num_pages * pb / 2 ** 20:.1f} MiB (storage "
        f"{(eng_b.pool.num_pages + 2) * pb / 2 ** 20:.1f} MiB with the zero "
        f"and trash pages; the largest request holds {need} pages) against "
        f"the contiguous arenas' {arena_bytes / 2 ** 20:.1f} MiB; peak "
        f"device memory {b['peak_gib']:.2f} vs {a['peak_gib']:.2f} GiB")
    add_counts(counts, b["counts"])
    del eng_b, srv_b
    gc_collect(torch)
    # (c) paged kv v2: two steps, then a priority-5 arrival evicts.
    pattern = eviction_pattern(S_SLOTS)
    holder = {}

    def drive(server, key):
        holder["suspends"] = count_calls(server.engine, "suspend")
        holder["resumes"] = count_calls(server.engine, "resume")
        return pattern(server, key, prompts, PAGED_MAX_NEW)
    eng_c, srv_c, c = serve_run(
        torch, dev, target, drafter, prompts, PAGED_MAX_NEW,
        "paged (c) paged kv v2 with a priority-5 arrival", paged=True,
        cache_mode="kv", policy="v2", min_buf=min_buf, pattern=drive)
    same_streams(a["streams"], c["streams"], "paged (c) vs (a)")
    m = srv_c.metrics
    assert m.evictions >= 1 and c["evicted_s"] > 0, (m.evictions,
                                                     c["evicted_s"])
    assert holder["suspends"] and set(holder["suspends"]) <= set(
        holder["resumes"]), holder
    assert m.draft_syncs == L_DRAFT * m.rounds, (m.draft_syncs, m.rounds)
    assert m.host_syncs == m.total_blocks, (m.host_syncs, m.total_blocks)
    from repro_torch.kernels.mode import launch_name
    d = target[1].resolved_head_dim
    dec = c["counts"].get(launch_name("decode_attention", d), 0)
    sweeps = L_DRAFT * d_layers * m.rounds
    # One launch a drafter layer a sweep: L sweeps a round plus a
    # catch-up sweep in rounds where a slot accepted every draft.
    assert dec == d_layers * eng_c.num_draft_forwards, (dec, sweeps)
    assert sweeps <= dec <= sweeps + d_layers * m.rounds, (dec, sweeps)
    assert c["counts"].get(launch_name("flash_attention", d), 0) == \
        layers * eng_c.num_prefill_dispatches // 2, c["counts"]
    assert c["counts"].get("gls_row_race", 0) == m.total_blocks
    log(f"paged (c): suspended uids {holder['suspends']}, resumed "
        f"{holder['resumes']}; decode launches {dec} = L x {d_layers} "
        f"drafter layers x {m.rounds} rounds + {(dec - sweeps) // d_layers} "
        f"catch-up sweeps")
    check_paged_end(eng_c, "paged (c)")
    add_counts(counts, c["counts"])
    del eng_c, srv_c
    gc_collect(torch)
    for what, st in (("(b) paged kv_fused v2", b), ("(c) paged kv v2", c)):
        compare_serves(st, a, f"paged {what} vs (a) contiguous kv_fused "
                       "fifo", smi)
    # (d) quant: int8 pages through kv_fused v2 against contiguous quant,
    # two of the four requests live at a time, rotating by suspend and
    # resume every PAGED_PREEMPT tokens (the pages grow on demand, so no
    # handle is stripped): streams equal.
    q_prompts = prompts[:PAGED_QUANT_REQUESTS]
    q_buf = max(len(p) for p in q_prompts) + PAGED_QUANT_MAX_NEW + \
        L_DRAFT + 2
    _, _, qa = serve_run(torch, dev, target, drafter, q_prompts,
                         PAGED_QUANT_MAX_NEW, "paged (d) contiguous quant "
                         "kv_fused fifo", quant=True, min_buf=q_buf)
    add_counts(counts, qa["counts"])
    gc_collect(torch)
    eng_d, srv_d, qb = serve_run(
        torch, dev, target, drafter, q_prompts, PAGED_QUANT_MAX_NEW,
        "paged (d) paged quant kv_fused v2, 2 live, rotating", quant=True,
        paged=True, policy="v2", preempt=PAGED_PREEMPT, min_buf=q_buf,
        max_batch=2)
    same_streams(qa["streams"], qb["streams"], "paged (d) quant vs contiguous")
    assert srv_d.metrics.preemptions > 0 and eng_d.num_view_refreshes > 0, \
        "paged (d): no suspend and resume"
    check_paged_end(eng_d, "paged (d)")
    add_counts(counts, qb["counts"])
    del eng_d, srv_d
    gc_collect(torch)
    # (d') the same over (b)'s fixed budget: page pressure strips suspend
    # handles, so requests re-prefill prompt + output through the flash
    # kernel and re-quantize.  The int8 rounding of K/V that the verify
    # chunk and the decode kernel built is not the re-prefill's (ROADMAP
    # queue 3, item 6), so the streams are logged, not held equal.
    eng_q, srv_q, qc = serve_run(
        torch, dev, target, drafter, q_prompts, PAGED_QUANT_MAX_NEW,
        "paged (d') paged quant kv_fused v2 over a fixed budget",
        quant=True, paged=True, policy="v2", preempt=PAGED_PREEMPT,
        pool_pages=budget, min_buf=q_buf)
    flips = {uid: next((i for i, (x, y) in enumerate(zip(qa["streams"][uid],
                                                         qc["streams"][uid]))
                        if x != y), None) for uid in qa["streams"]}
    log(f"paged (d'): {srv_q.metrics.evictions} evictions (stripped "
        f"handles re-prefill), {eng_q.num_view_refreshes} resumes; first "
        f"token differing from contiguous quant per uid: {flips}")
    check_paged_end(eng_q, "paged (d')")
    add_counts(counts, qc["counts"])
    del eng_q, srv_q
    gc_collect(torch)
    return counts


def phase_dense_calls(torch, dev, target):
    """The dense serving calls at full width: ``prefill`` of 90 tokens,
    one ``decode_step`` and a 10-token ``verify_step`` against one dense
    ``forward`` over all 100 (logits within 1e-3, as phase 2b); then
    ``forward`` over 2,560 tokens, chunked attention (the default past
    2,048) against the dense path (1e-4)."""
    from repro_torch.models import decode_step, forward, init_cache, prefill
    from repro_torch.models.transformer import verify_step
    params, cfg = target
    rng = np.random.default_rng(SEED + 9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 100)).astype(
        np.int32)).to(dev)
    ref = forward(params, cfg, {"tokens": toks})[:, 89:]
    cache = init_cache(cfg, 2, 128, dev)
    lp, cache = prefill(params, cfg, {"tokens": toks[:, :90]}, cache)
    ld, cache = decode_step(params, cfg, toks[:, 90:91], cache)
    lv, cache = verify_step(params, cfg, toks[:, 91:], cache)
    got = torch.cat([lp[:, None], ld[:, None], lv], dim=1)
    err = float((got - ref).abs().max())
    assert cache["pos"] == 100 and bool(torch.isfinite(got).all())
    long = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2560)).astype(
        np.int32)).to(dev)
    chunked = forward(params, cfg, {"tokens": long})
    dense = forward(params, cfg, {"tokens": long}, chunked=False)
    err_long = float((chunked - dense).abs().max())
    log(f"dense calls, {cfg.num_layers} layers: prefill + decode_step + "
        f"verify_step vs forward max abs logit err {err:.3g} (tolerance "
        f"1e-3); forward at 2560 tokens, chunked vs dense attention "
        f"{err_long:.3g} (tolerance 1e-4)")
    assert err <= 1e-3, err
    assert bool(torch.isfinite(chunked).all()) and err_long <= 1e-4, err_long
    del ref, got, chunked, dense
    gc_collect(torch)


def _scaled(tree, factor: float):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled(v, factor) for v in tree]
    return tree * factor


def phase_diverse(torch, dev, target, drafter, smi: str) -> dict:
    """Heterogeneous drafters in the reference engine at full width: the
    smollm-360m target through ``SpecDecServer(cache_mode="reprefill")``,
    K = 2, L = 5, target temperature 2.0, top-k 50, the kernel verifier,
    ``DIVERSE_REQUESTS`` requests of ``DIVERSE_MAX_NEW`` tokens.  Serves:
    gls and specinfer with phase 3's drafter at temperatures (0.5, 1.0)
    and (1.0, 0.5), and gls with two distinct drafters (phase 3's 4-layer
    drafter, seed 1, and a 2-layer one, seed 2).  Checks: K drafter
    forwards a draft step, ``gls_row_race`` launches equal to the
    requests' blocks for gls and none for specinfer; then drafter
    invariance: the drafter against itself scaled by 1 + 1e-4, GLS on
    the same keys, equal outputs in at least 8 of 10 generations
    (``test_specdec.py::test_engine_conditional_invariance``).  Returns
    the serves' launch counts."""
    from repro_torch import random as R
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import init_params
    from repro_torch.specdec import SpecDecConfig, SpecDecEngine
    from repro_torch.specdec import SpecDecServer
    k, l_draft = 2, 5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    small_cfg = drafter[1].replace(name=drafter[1].name + "-2",
                                   num_layers=2)
    small = (init_params(gen, small_cfg, dev), small_cfg)
    vocab = target[1].vocab_size
    prompts = draw_prompts(DIVERSE_REQUESTS, vocab, PROMPT_MIN, 64, SEED + 4)
    counts = {}
    for strategy, temps, drafters in (
            ("gls", (0.5, 1.0), [drafter]), ("gls", (1.0, 0.5), [drafter]),
            ("specinfer", (0.5, 1.0), [drafter]),
            ("specinfer", (1.0, 0.5), [drafter]),
            ("gls", (0.5, 1.0), [drafter, small])):
        cfg = SpecDecConfig(num_drafts=k, draft_len=l_draft,
                            strategy=strategy, target_temp=2.0,
                            draft_temps=temps, top_k=50,
                            verifier_backend="kernel")
        engine = SpecDecEngine(target, drafters, cfg, device=dev)
        server = SpecDecServer(engine, max_batch=DIVERSE_REQUESTS,
                               cache_mode="reprefill")
        for p in prompts:
            server.submit(p, max_new=DIVERSE_MAX_NEW)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        done = server.run(R.PRNGKey(SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = dict(launch_counts)
        add_counts(counts, c)
        m = server.metrics
        assert len(done) == DIVERSE_REQUESTS and all(
            len(r.output) == DIVERSE_MAX_NEW for r in done), strategy
        assert all(0 <= t < vocab for r in done for t in r.output)
        assert engine.num_draft_forwards == \
            k * l_draft * engine.num_target_forwards, (
                engine.num_draft_forwards, engine.num_target_forwards)
        races = c.get("gls_row_race", 0)
        assert races == (m.total_blocks if strategy == "gls" else 0), (
            strategy, c, m.total_blocks)
        names = "+".join(f"{d[1].num_layers}L" for d in drafters)
        log(f"diverse drafts [{smi}] {strategy} temps {temps} drafters "
            f"{names}: {len(done)} requests x {DIVERSE_MAX_NEW} tokens in "
            f"{wall:.3f}s, rounds {m.rounds}, block efficiency per request "
            f"{[round(r.block_efficiency, 3) for r in done]} (mean "
            f"{m.mean_block_efficiency:.3f}; random weights), "
            f"accepted per block "
            f"{sum(r.accepted for r in done) / m.total_blocks:.3f}, "
            f"draft forwards {engine.num_draft_forwards} = K x L x "
            f"{engine.num_target_forwards} target forwards, launches {c}")
        del engine, server
    twin = (_scaled(drafter[0], 1.0 + 1e-4), drafter[1])
    cfg = SpecDecConfig(num_drafts=k, draft_len=l_draft, strategy="gls",
                        top_k=0, verifier_backend="kernel")
    e1 = SpecDecEngine(target, [drafter], cfg, device=dev)
    e2 = SpecDecEngine(target, [twin], cfg, device=dev)
    matched = 0
    for i in range(10):
        o1 = e1.generate(R.PRNGKey(100 + i), prompts[i % len(prompts)][:16],
                         max_new=6)
        o2 = e2.generate(R.PRNGKey(100 + i), prompts[i % len(prompts)][:16],
                         max_new=6)
        matched += int(np.array_equal(o1.output, o2.output))
    log(f"diverse drafts: drafter invariance (drafter vs drafter x "
        f"(1 + 1e-4), GLS, same keys): {matched}/10 generations equal "
        f"(need >= 8)")
    assert matched >= 8, matched
    del twin, small, e1, e2
    gc_collect(torch)
    return counts


def self_draft_units(arch: str) -> int:
    """The units phases 4 and 4q take for ``arch``: the mean's standard
    error at most ``QUANT_SE_AIM`` at the largest sd measured."""
    return math.ceil((QUANT_RATE_READINGS[arch][1] / QUANT_SE_AIM) ** 2)


def quant_rate_floor(arch: str) -> float:
    """The least served quant self-draft rate phase 4q accepts for
    ``arch``: the measured mean less 3 standard errors."""
    mean, sd = QUANT_RATE_READINGS[arch]
    return mean - 3 * sd / self_draft_units(arch) ** 0.5


def self_draft_unit(vocab: int, i: int):
    """Unit ``i`` of the self-draft sample: ``S_SLOTS`` prompts of
    ``SELF_DRAFT_PROMPT`` tokens (numpy, seeded) and the seed of its round
    key.  Unit 0's first two prompts and key are the 2-prompt sample that
    phases 4 and 4q judged alone before the sample was widened."""
    prompts = np.random.default_rng(SEED + 3 + 1000 * i).integers(
        0, vocab, (S_SLOTS, SELF_DRAFT_PROMPT)).astype(np.int32)
    return prompts, SEED + 1 + 1000 * i


def self_draft_engine(torch, dev, target, kind: str = "float32"):
    """A self-draft engine (drafter = target): "float32", or "quant",
    ``SpecDecConfig(quant=True)`` as served (int8 K/V arenas through the
    int8 attention instances and quantize-on-write, and the target's
    W8A8 verify tree)."""
    engine, _ = make_server(torch, dev, target, target, S_SLOTS,
                            quant=kind == "quant")
    return engine


def self_draft_rates(torch, dev, target, kind: str, units: int,
                     engine=None):
    """The self-draft workload over ``units`` units (``self_draft_unit``),
    each served alone by one server with all ``S_SLOTS`` slots live and
    its own round key, ``SELF_DRAFT_NEW`` new tokens a request, on
    ``engine`` (``self_draft_engine(kind)`` if None).  Returns one
    (accepted, blocks, rounds) per unit, and the accepted and blocks of
    unit 0's requests 1 and 2 (the old 2-prompt sample: the same prompts,
    keys and slots, and a slot's rows are computed independently of the
    others)."""
    from repro_torch import random as R
    from repro_torch.specdec import SpecDecServer
    if engine is None:
        engine = self_draft_engine(torch, dev, target, kind)
    vocab = target[1].vocab_size
    per_unit, old = [], (0, 0)
    for i in range(units):
        server = SpecDecServer(engine, max_batch=S_SLOTS)
        prompts, seed = self_draft_unit(vocab, i)
        for p in prompts:
            server.submit(p, max_new=SELF_DRAFT_NEW)
        done = server.run(R.PRNGKey(seed))
        per_unit.append((sum(r.accepted for r in done),
                         sum(r.blocks for r in done),
                         server.metrics.rounds))
        if i == 0:
            old = (sum(r.accepted for r in done if r.uid <= 2),
                   sum(r.blocks for r in done if r.uid <= 2))
    return per_unit, old


def rate_stats(per_unit):
    """The units' acceptance rates (accepted / (blocks L)), their mean and
    sample standard deviation, and the standard error of the mean."""
    rates = [a / (b * L_DRAFT) for a, b, _ in per_unit]
    mean = statistics.fmean(rates)
    sd = statistics.stdev(rates) if len(rates) > 1 else float("nan")
    return rates, mean, sd, sd / len(rates) ** 0.5


def phase_self_draft(torch, dev, target, kind="float32", label=""):
    """Phase 4 (``kind`` "float32") or 4q's run ("quant") over the
    model's ``self_draft_units``: the per-unit acceptance rates, logged
    with their mean, sd and standard error and the old 2-prompt sample's
    rate; float32 must accept >= 0.9 L per block over the sample.
    Returns the mean rate and its standard error."""
    per_unit, old = self_draft_rates(torch, dev, target, kind,
                                     self_draft_units(target[1].name))
    gc_collect(torch)
    acc = sum(a for a, _, _ in per_unit) / sum(b for _, b, _ in per_unit)
    rates, mean, sd, se = rate_stats(per_unit)
    log(f"{label}self-draft {kind}: {len(per_unit)} units x {S_SLOTS} "
        f"prompts, rounds {[n for _, _, n in per_unit]}, mean accepted per "
        f"block {acc:.3f} (L={L_DRAFT}"
        + (f", need >= {0.9 * L_DRAFT:.1f}" if kind == "float32" else "")
        + f"), rate per unit {[round(r, 4) for r in rates]}, mean "
        f"{mean:.4f} sd {sd:.4f} se {se:.4f}; the old 2-prompt sample "
        f"{old[0] / (old[1] * L_DRAFT):.4f}")
    assert min(n for _, _, n in per_unit) >= 8, per_unit
    if kind == "float32":
        assert acc >= 0.9 * L_DRAFT, f"self-draft acceptance {acc:.3f}"
    return mean, se


def phase_quant_self_draft(torch, dev, target, rate_f32: float,
                           label: str = ""):
    """Phase 4q on phase 4's units (the same prompts and keys): the served
    quant path (int8 arenas and the W8A8 verify) must keep its mean
    acceptance rate at or above ``quant_rate_floor``, the rate measured
    over 12 units less 3 standard errors, so that a broken W8A8 verify,
    ``quantize_kv`` or int8 attention instance fails.  Its distance from
    float32's rate is logged against ``QUANT_RATE_TOL``: over a sample
    whose standard error is at most 0.03 the rate sits at or past that
    edge at both widths with either flash route, on JAX's semantics (the
    CPU token streams are JAX's): ROADMAP queue 3, item 1."""
    arch = target[1].name
    rate_q, se_q = phase_self_draft(torch, dev, target, "quant", label)
    floor = quant_rate_floor(arch)
    log(f"{label}quant self-draft: acceptance rate {rate_q:.4f} (se "
        f"{se_q:.4f}), held >= {floor:.4f} (the 12-unit mean "
        f"{QUANT_RATE_READINGS[arch][0]} less 3 standard errors); vs "
        f"float32 {rate_f32:.4f}: |diff| {abs(rate_q - rate_f32):.4f}, "
        f"{'within' if abs(rate_q - rate_f32) <= QUANT_RATE_TOL else 'past'}"
        f" the tolerance {QUANT_RATE_TOL} (ROADMAP queue 3)")
    assert rate_q >= floor, (rate_q, floor)
    return rate_q


def gc_collect(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase rs: the rejection-sampling baselines on the kv_fused path
# ---------------------------------------------------------------------------


def rs_block_inputs(torch, dev, vocab: int, seed: int):
    """One fused round's verifier inputs at the serve shape (S, K, L, N):
    p from top-50 probabilities of random logits (one per slot and step,
    shared by the K drafts, as one drafter gives them), q from the same
    logits plus a little noise (so blocks accept several drafts before a
    rejection),
    the drafts raced from the round's shared uniforms, and the strategy
    keys of ``block_randomness``."""
    from repro_torch import random as R
    from repro_torch.specdec import block_randomness, probs_from_logits
    from repro_torch.specdec import verify as V
    s, k, el = S_SLOTS, K_DRAFTS, L_DRAFT
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    logits = 3.0 * torch.randn(s, 1, el + 1, vocab, generator=gen,
                               device=dev)
    p = probs_from_logits(logits[:, :, :el].expand(s, k, el, vocab), 1.0,
                          50, vocab).contiguous()
    q = probs_from_logits(logits + 0.2 * torch.randn(
        s, k, el + 1, vocab, generator=gen, device=dev), 1.0, 50, vocab)
    subs = R.split(R.PRNGKey(seed), s).to(dev)
    log_u, strat_keys = block_randomness(subs, el, k, vocab)
    d = V.draft_token_from_uniforms(log_u[:, :el].transpose(1, 2), p)
    return log_u, d, p, q, strat_keys


def phase_rs_verify(torch, dev, vocab: int):
    """The batched rejection-sampling verifier on the card against the
    CPU on the same tensors at (S, K, L, N) = (4, 8, 4, vocab) (single at
    K = 1): equal tokens, accepted counts, active masks and bonus flags;
    then the legacy host loop against the fused verifier for one block
    of each of the six strategies, on the card."""
    from repro_torch.specdec import STRATEGIES, block_verify_batched
    from repro_torch.specdec.block_verify import run_block_verify
    log_u, d, p, q, keys = rs_block_inputs(torch, dev, vocab, SEED + 11)
    for strategy in ("specinfer", "spectr", "single"):
        k = 1 if strategy == "single" else K_DRAFTS
        args = (log_u[:, :, :k], d[:, :k], p[:, :k], q[:, :k], keys)
        t0 = time.perf_counter()
        card = block_verify_batched(*args, strategy=strategy,
                                    backend="kernel")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = block_verify_batched(*(a.cpu() for a in args),
                                   strategy=strategy, backend="torch")
        for name, a, b in zip(card._fields, card, cpu):
            assert torch.equal(a.cpu(), b), (strategy, name, a, b)
        log(f"rs verify {strategy} at (S, K, L, N) = ({S_SLOTS}, {k}, "
            f"{L_DRAFT}, {vocab}): card == CPU (tokens, num_accepted, "
            f"active, bonus); accepted per slot "
            f"{card.num_accepted.tolist()}, first call {ms:.1f} ms")
    for strategy in STRATEGIES:
        k = 1 if strategy in ("single", "daliri") else K_DRAFTS
        args = (log_u[0, :, :k], d[0, :k].cpu().numpy(), p[0, :k], q[0, :k],
                keys[0])
        legacy = run_block_verify(*args, strategy=strategy,
                                  backend="legacy")
        fused = run_block_verify(*args, strategy=strategy, backend="kernel")
        assert legacy.new_tokens == fused.new_tokens, (strategy, legacy,
                                                      fused)
        assert legacy.num_accepted == fused.num_accepted, strategy
        assert (legacy.active == fused.active).all(), strategy
        log(f"rs legacy == fused, {strategy}: tokens {fused.new_tokens} "
            f"(legacy host syncs {legacy.host_syncs}, fused 1)")


def launches_per_round(torch, server, key, warmup: int = 3,
                       rounds: int = 3) -> dict:
    """Step ``warmup`` rounds, then trace ``rounds`` more under
    ``torch.profiler``: CUDA launches per round and the per-phase host
    and device ms of ``launch.profile_round.analyse``."""
    from repro_torch.launch.profile_round import analyse
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(warmup):
        server.step(key)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(rounds):
            with torch.profiler.record_function("serve/step"):
                server.step(key)
        torch.cuda.synchronize()
    path = os.path.join(HERE, "build", "chip_smoke_rs_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        res = analyse(json.load(f), rounds)
    os.remove(path)
    return res


def phase_rs_serve(torch, dev, target, drafter, strategy: str, smi: str):
    """The phase 3 server (both attention kernels, the kernel verifier)
    for ``strategy``, ``RS_REQUESTS`` requests of ``RS_MAX_NEW`` new
    tokens: completion, token range, the sync gates, the launch counts
    of this path's run (decode and flash grew; the row race launched
    only for the race family), then launches per round from a traced
    window of a second run of the same requests."""
    from repro_torch import random as R
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import draw_prompts
    vocab = target[1].vocab_size
    prompts = draw_prompts(RS_REQUESTS, vocab, PROMPT_MIN, PROMPT_MAX, SEED)
    engine, server = make_server(torch, dev, target, drafter, S_SLOTS,
                                 strategy=strategy)
    for pr in prompts:
        server.submit(pr, max_new=RS_MAX_NEW)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = server.run(R.PRNGKey(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    m = server.metrics
    assert len(done) == RS_REQUESTS, (strategy, len(done))
    for r in done:
        out = np.asarray(r.output)
        assert len(out) == RS_MAX_NEW, (strategy, r.uid, len(out))
        assert out.min() >= 0 and out.max() < vocab, (strategy, r.uid)
    assert m.draft_syncs == 0, (strategy, m.draft_syncs)
    assert m.host_syncs == m.rounds, (strategy, m.host_syncs, m.rounds)
    assert counts.get("decode_attention", 0) > 0, (strategy, counts)
    assert counts.get("flash_attention", 0) > 0, (strategy, counts)
    races = counts.get("gls_row_race", 0)
    if strategy == "gls":
        assert races == m.rounds, (strategy, counts)
    else:
        assert races == 0, (strategy, counts)
    acc = sum(r.accepted for r in done) / sum(r.blocks for r in done)
    del engine, server
    engine, server = make_server(torch, dev, target, drafter, S_SLOTS,
                                 strategy=strategy)
    for pr in prompts:
        server.submit(pr, max_new=RS_MAX_NEW)
    prof = launches_per_round(torch, server, R.PRNGKey(SEED))
    bv = prof["phases"].get("round/block_verify", {})
    stats = {"tok_s": m.total_tokens / wall, "round_ms": wall / m.rounds * 1e3,
             "accepted_per_block": acc, "rounds": m.rounds,
             "launches_per_round": prof["launches_per_round"],
             "block_verify_device_ms": bv.get("device_ms", 0.0),
             "block_verify_host_ms": bv.get("host_ms", 0.0)}
    log(f"rs serve {strategy} [{smi}]: {len(done)} requests, "
        f"{m.total_tokens} tokens in {wall:.3f}s -> {stats['tok_s']:.1f} "
        f"tok/s; rounds={m.rounds} round wall {stats['round_ms']:.1f} ms "
        f"accepted per block={acc:.3f} host_syncs={m.host_syncs} "
        f"draft_syncs={m.draft_syncs} launches={counts}; traced window: "
        f"{prof['launches_per_round']:.0f} CUDA launches per round, "
        f"round/block_verify device {stats['block_verify_device_ms']:.3f} "
        f"ms host {stats['block_verify_host_ms']:.3f} ms")
    return counts, stats


def phase_rs_self_draft(torch, dev, target, strategy: str) -> float:
    """Drafter = target, ``RS_SELF_REQUESTS`` requests of 48 tokens.
    specinfer tries draft 0 first and single has only draft 0; with
    q = p draft 0 is accepted (up to near-ties of q/p at 1) and stays on
    the path, so both reach 0.9 L.  spectr accepts each active draft
    with b = min(1, q / (J p)) = 1/J, but reads row 0 of p and q (JAX's
    ``verify.py:162-163``), the distributions along draft 0's path: a
    step where draft 0 is active accepts with probability
    1 - (1 - 1/J)^J >= a_K = 1 - (1 - 1/K)^K, and draft 0 stays active
    with probability >= 1/J >= 1/K (it is tried first); once draft 0 has
    left the path a step may reject whatever J.  So the mean accepted
    per block is at least sum_{i=1..L} a_K K^-(i-1), and the blocks that
    accept their first step a share of at least a_K; each is held to
    its bound less 3 standard errors of the measured mean."""
    from repro_torch import random as R
    engine, server = make_server(torch, dev, target, target,
                                 RS_SELF_REQUESTS, strategy=strategy)
    per_block = []
    round_with_admission = engine.round_with_admission

    def recorded(*args, **kw):
        outs = round_with_admission(*args, **kw)
        per_block.extend(o.accepted for o in outs)
        return outs

    engine.round_with_admission = recorded
    vocab = target[1].vocab_size
    for pr in np.random.default_rng(SEED + 3).integers(
            0, vocab, (RS_SELF_REQUESTS, 64)).astype(np.int32):
        server.submit(pr, max_new=48)
    server.run(R.PRNGKey(SEED + 1))
    acc = np.asarray(per_block, np.float64)
    mean = float(acc.mean())
    se = float(acc.std(ddof=1) / np.sqrt(len(acc)))
    assert len(acc) >= 8, (strategy, len(acc))
    if strategy != "spectr":
        log(f"rs self-draft {strategy}: blocks={len(acc)} mean accepted "
            f"per block={mean:.3f} (L={L_DRAFT}, need >= "
            f"{0.9 * L_DRAFT:.1f})")
        assert mean >= 0.9 * L_DRAFT, (strategy, mean)
        return mean
    a_k = 1.0 - (1.0 - 1.0 / K_DRAFTS) ** K_DRAFTS
    need = sum(a_k * K_DRAFTS ** -i for i in range(L_DRAFT))
    first = acc > 0
    first_se = float(first.std(ddof=1) / np.sqrt(len(acc)))
    log(f"rs self-draft spectr: blocks={len(acc)} mean accepted per block="
        f"{mean:.3f} (SE {se:.3f}; need >= {need:.3f} - 3 SE = "
        f"{need - 3 * se:.3f}; with every step on its active rows it would "
        f"be >= sum a_K^i = "
        f"{sum(a_k ** i for i in range(1, L_DRAFT + 1)):.3f}); first step "
        f"accepted in {first.mean():.3f} of blocks (SE {first_se:.3f}; need "
        f">= a_K = {a_k:.3f} - 3 SE); accepted per block histogram "
        f"{np.bincount(acc.astype(int), minlength=L_DRAFT + 1).tolist()}")
    assert mean >= need - 3 * se, (mean, need, se)
    assert first.mean() >= a_k - 3 * first_se, (first.mean(), a_k)
    return mean


# ---------------------------------------------------------------------------
# Phase granite: a head-dim-128 model through the kv_fused path
# ---------------------------------------------------------------------------


def phase_granite(torch, dev, smi: str, buf_len: int):
    """granite-8b at its published widths (36-layer target, 4-layer
    drafter of the same widths, weights from seeds 0 and 1, float32):
    the head-dim-128 instances of both attention kernels (float32 and
    int8) against their plain versions at its serve shapes, the cached
    kernel path against a dense forward, the phase 3 server and its
    quant twin with ``RS_REQUESTS`` requests of ``RS_MAX_NEW`` tokens,
    the float32 serve again through ``cache_mode="kv"`` (streams equal
    to the kv_fused serve's), and the self-draft checks of phases 4 and
    4q.  Frees the pair before
    it returns (kernel records, the float32 and quant serves' launch
    counts)."""
    from repro_torch.launch.serve import build_pair
    t0 = time.perf_counter()
    target, drafter = build_pair("granite-8b", 4, SEED, dev)
    torch.cuda.synchronize()
    cfg = target[1]
    n_params = [sum(x.numel() for x in _leaves(p)) for p, _ in
                (target, drafter)]
    log(f"granite: {cfg.num_layers}-layer target ({n_params[0] / 1e9:.3f}e9 "
        f"parameters) and {drafter[1].num_layers}-layer drafter "
        f"({n_params[1] / 1e9:.3f}e9), head dim {cfg.resolved_head_dim}, "
        f"{cfg.num_heads // cfg.kv_heads} query heads per KV head, built "
        f"in {time.perf_counter() - t0:.1f}s")
    kernels = [kernel_decode(torch, dev, cfg, buf_len),
               kernel_flash(torch, dev, cfg, 256, buf_len),
               kernel_decode_int8(torch, dev, cfg, buf_len),
               kernel_flash(torch, dev, cfg, 256, buf_len, int8=True)]
    for kr in kernels:
        log_kernel(kr, smi)
    phase_reference(torch, dev, target)
    counts, stats = phase_serve(torch, dev, target, drafter,
                                requests=RS_REQUESTS, max_new=RS_MAX_NEW,
                                label="granite serve")
    gc_collect(torch)
    kv_counts, kv_stats = phase_serve(torch, dev, target, drafter,
                                      requests=RS_REQUESTS,
                                      max_new=RS_MAX_NEW,
                                      label="granite kv serve",
                                      cache_mode="kv")
    same_streams(stats["streams"], kv_stats["streams"],
                 "granite kv vs kv_fused")
    compare_serves(kv_stats, stats, "granite kv vs kv_fused serve", smi)
    add_counts(counts, kv_counts)
    gc_collect(torch)
    # (e) of phase paged: the kv workload paged (the head-dim-128 decode
    # and flash through the page table), its buffer pinned to the one the
    # contiguous kv serve reached.
    check_paged_kernels(torch, dev, cfg, buf_len, smi)
    eng_e, srv_e, e = serve_run(
        torch, dev, target, drafter,
        paged_trace(cfg.vocab_size, RS_REQUESTS), RS_MAX_NEW,
        "paged (e) granite paged kv v2", paged=True, cache_mode="kv",
        policy="v2", min_buf=kv_stats["buf_len"])
    same_streams(kv_stats["streams"], e["streams"],
                 "paged (e) granite paged kv vs contiguous kv")
    m = srv_e.metrics
    assert m.draft_syncs == L_DRAFT * m.rounds, (m.draft_syncs, m.rounds)
    assert m.host_syncs == m.total_blocks, (m.host_syncs, m.total_blocks)
    assert e["counts"].get("decode_attention_d128", 0) >= \
        L_DRAFT * drafter[1].num_layers * m.rounds, e["counts"]
    assert e["counts"].get("flash_attention_d128", 0) > 0, e["counts"]
    check_paged_end(eng_e, "paged (e)")
    compare_serves(e, kv_stats, "paged (e) granite paged kv vs contiguous "
                   "kv", smi)
    add_counts(counts, e["counts"])
    del eng_e, srv_e
    gc_collect(torch)
    q_counts, q_stats = phase_serve(torch, dev, target, drafter, quant=True,
                                    requests=RS_REQUESTS, max_new=RS_MAX_NEW,
                                    label="granite serve")
    gc_collect(torch)
    for kr in kernels[2:]:
        counts[kr["name"]] = q_counts.get(kr["name"], 0)
    log(f"granite quant vs float32 serve [{smi}]: "
        + ", ".join(f"{k} {q_stats[k]:.4g} vs {stats[k]:.4g}"
                    for k in ("tok_s", "round_ms", "ttft_ms", "peak_gib",
                              "arena_mib")))
    rate_f32, _ = phase_self_draft(torch, dev, target, label="granite ")
    phase_quant_self_draft(torch, dev, target, rate_f32, label="granite ")
    del target, drafter
    gc_collect(torch)
    return kernels, counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phases 5 and 6: compression and the joint race
# ---------------------------------------------------------------------------


def phase_compress(torch, dev):
    from repro_torch import random as R
    from repro_torch.compression import gaussian as G
    from repro_torch.compression.pipeline import check_wz_batch, WZBatch
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    cfg = G.GaussianWZ(sigma2_w_given_a=WZ_SIGMA2, n_atoms=WZ_ATOMS)
    key = R.PRNGKey(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = G.run_experiment(key, cfg, WZ_K, WZ_LMAX, WZ_TRIALS,
                           backend="kernel", batch_size=WZ_BATCH,
                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chunks = -(-WZ_TRIALS // WZ_BATCH)
    assert counts.get("gls_binned_race", 0) == chunks, (counts, chunks)
    margin = res["match_prob_any"] - res["match_lower_bound"]
    log(f"compress: {WZ_TRIALS} trials, B={WZ_BATCH} N={WZ_ATOMS} "
        f"K={WZ_K} l_max={WZ_LMAX} sigma2_w|a={WZ_SIGMA2}: "
        f"{WZ_TRIALS / wall:.1f} trials/s ({wall:.3f}s), peak device "
        f"memory {peak:.2f} GiB, launches={counts}; match_prob_any="
        f"{res['match_prob_any']:.4f} bound={res['match_lower_bound']:.4f} "
        f"(margin {margin:+.4f}, allowance {BOUND_ALLOWANCE}) distortion="
        f"{res['distortion_db']:.2f} dB")
    assert margin >= -BOUND_ALLOWANCE, res
    # Every chunk again through both backends: equal outputs, the guard
    # passes.
    keys = R.split(key.to(dev), WZ_TRIALS)
    for i in range(0, WZ_TRIALS, WZ_BATCH):
        outs = [G._batch_trials(keys[i:i + WZ_BATCH], cfg, WZ_K, WZ_LMAX,
                                False, backend) for backend in ("kernel",
                                                                "torch")]
        for name, a, c in zip(("match", "best_sq", "info_bits", "y",
                               "message", "x", "ok"), *outs):
            assert torch.equal(a, c), f"chunk {i}: {name} kernel != torch"
        match, _, _, y, message, x, ok = outs[0]
        check_wz_batch(WZBatch(y, message, x, match, ok), n_atoms=WZ_ATOMS,
                       l_max=WZ_LMAX, what=f"chunk {i}")
    log(f"compress: {chunks} chunks, kernel == torch backend on every "
        f"output; validate_wz_batch passed")
    # A small case against the JAX reference's recorded match rates.
    small = G.run_experiment(key, G.GaussianWZ(sigma2_w_given_a=WZ_SIGMA2,
                                               n_atoms=2048), 4, 8, 200,
                             backend="kernel", device=dev)
    got = (small["match_prob_any"], small["match_prob_each"])
    log(f"compress: small case (N=2048, K=4, l_max=8, 200 trials) match "
        f"{got}, JAX reference {JAX_SMALL_CASE}")
    assert got == JAX_SMALL_CASE, (got, JAX_SMALL_CASE)
    return counts, {"trials_per_s": WZ_TRIALS / wall, "wall_s": wall,
                    "peak_gib": peak, **res}


def phase_fig2(torch, dev):
    from repro_torch import random as R
    from repro_torch.compression import gaussian as G
    cfg = G.GaussianWZ(sigma2_w_given_a=WZ_SIGMA2, n_atoms=GRID_ATOMS)
    key = R.PRNGKey(SEED)
    log(f"fig2 (N={GRID_ATOMS}, {GRID_TRIALS} trials, sigma2_w|a="
        f"{WZ_SIGMA2}): rate K  GLS match / D(dB)  baseline match / D(dB)"
        f"  bound  GLS-bound")
    rows = []
    for l_max in (2, 8, 64):
        for k in (1, 2, 4):
            gls_r = G.run_experiment(key, cfg, k, l_max, GRID_TRIALS,
                                     backend="kernel", device=dev)
            base = G.run_experiment(key, cfg, k, l_max, GRID_TRIALS,
                                    shared_sheet=True, backend="kernel",
                                    device=dev)
            margin = gls_r["match_prob_any"] - gls_r["match_lower_bound"]
            log(f"fig2: {gls_r['rate_bits']:.0f} {k}  "
                f"{gls_r['match_prob_any']:.4f} / "
                f"{gls_r['distortion_db']:.2f}  "
                f"{base['match_prob_any']:.4f} / {base['distortion_db']:.2f}"
                f"  {gls_r['match_lower_bound']:.4f}  {margin:+.4f}")
            if k == 1:
                assert gls_r == base, ("GLS != baseline at K=1", gls_r, base)
            assert margin >= -BOUND_ALLOWANCE, (l_max, k, gls_r)
            rows.append((l_max, k, gls_r, base))
    return rows


def phase_gls(torch, dev):
    """The joint race kernel against the port's Algorithm 1 on the same
    sheets (as tests/test_kernel_engine_integration.py holds the Pallas
    kernel against the engine's verifier)."""
    from repro_torch import random as R
    from repro_torch.core import gls as C
    from repro_torch.kernels.gls_race.ops import gls_race
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    b, k, n = S_SLOTS * (L_DRAFT + 1), K_DRAFTS, 49152
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 30)
    ps = torch.softmax(2.0 * torch.randn((b, k, n), generator=g,
                                         device=dev), dim=-1)
    q = torch.softmax(2.0 * torch.randn((b, n), generator=g, device=dev),
                      dim=-1)
    ps[:, :, :16] = 0.0                 # zero-probability symbols
    keys = R.split(R.PRNGKey(SEED).to(dev), b)
    ref = C.gls_sample_heterogeneous(keys, ps, q)
    log_s = C.exponential_races(keys, k, n)
    log_p = C._safe_log(ps)
    log_q = C._safe_log(q)[:, None, :].expand(b, k, n)
    active = torch.ones((b, k), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    x, y = gls_race(log_s, log_p, log_q, active)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    assert counts.get("gls_race", 0) == 1, counts
    assert torch.equal(x, ref.x) and torch.equal(y, ref.y), \
        "gls_race != core.gls.gls_sample_heterogeneous"
    assert bool((x >= 16).all())
    acc = float(ref.accept.float().mean())
    log(f"gls: gls_race == gls_sample_heterogeneous on {b} rows x {k} "
        f"drafts x {n} symbols; acceptance {acc:.3f}; launches={counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 7: Mamba-2 through the reference engine
# ---------------------------------------------------------------------------


def ssd_serve_shape(cfg):
    """The ``ssd_chunk`` shape of the serve sub-phase: R * K rows and the
    buffer of the longest request padded to whole chunks."""
    from repro_torch.launch import profile_reprefill as W
    q = cfg.ssm_chunk
    return (W.REQUESTS * W.DRAFTS, -(-W.buffer_len() // q), q,
            cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state)


def _ssd_float64(torch, x, dt, a, b_in, c_in):
    """``ssd_chunk_ref``'s y and states in float64: the yardstick that
    says whether the kernel or the plain version sums more exactly."""
    x, dt, a, b_in, c_in = (t.double() for t in (x, dt, a, b_in, c_in))
    q = x.shape[2]
    cum = torch.cumsum(dt * a, dim=2)                      # (b, nc, q, h)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None] - cum[:, :, None]            # (b, nc, i, j, h)
    decay = torch.where(tri[..., None], torch.exp(torch.where(
        tri[..., None], diff, 0.0)), 0.0)
    w = torch.einsum("bcin,bcjn->bcij", c_in, b_in)[..., None] * decay
    xdt = x * dt[..., None]
    rem = torch.exp(cum[:, :, -1:] - cum)
    return (torch.einsum("bcijh,bcjhp->bcihp", w, xdt),
            torch.einsum("bcjh,bcjn,bcjhp->bchpn", rem, b_in, xdt))


def kernel_ssd(torch, dev, cfg):
    """``ssd_chunk`` against its plain version at the serve shape, on the
    input distributions of the JAX kernel test."""
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_plain
    b, nc, q, h, p, n = ssd_serve_shape(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 40)
    x = torch.randn((b, nc, q, h, p), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, q, h), generator=g, device=dev))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device=dev))
    b_in = torch.randn((b, nc, q, n), generator=g, device=dev)
    c_in = torch.randn((b, nc, q, n), generator=g, device=dev)
    args = (x, dt, a, b_in, c_in)
    got = ssd_chunk(*args)
    want = ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, k_, p_, tol in zip(("y", "states", "total"), got, want,
                                 (SSD_TOL, SSD_TOL, SSD_TOL_TOTAL)):
        assert bool(torch.isfinite(k_).all()), f"ssd_chunk {name} not finite"
        d = (k_ - p_).abs()
        assert bool((d <= tol + tol * p_.abs()).all()), \
            f"ssd_chunk {name}: max abs err {float(d.max())}"
        err = max(err, float(d.max()))
    exact = _ssd_float64(torch, *args)
    err64 = {route: [float((o.double() - e).abs().max())
                     for o, e in zip(outs[:2], exact)]
             for route, outs in (("kernel", got), ("plain", want))}
    del exact
    # The library yardstick: the three products as torch.matmul calls
    # over a precomputed decay, x dt and B (.) exp(total - cum).
    cum = torch.cumsum(dt * a, dim=2).permute(0, 1, 3, 2)   # (b, nc, h, q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    decay = torch.where(tri, torch.exp(diff), 0.0)         # (b, nc, h, q, q)
    xdt = (x * dt[..., None]).permute(0, 1, 3, 2, 4).contiguous()
    brem = b_in[:, :, None] * torch.exp(cum[..., -1:] - cum)[..., None]

    def products():
        cb = torch.matmul(c_in, b_in.transpose(-1, -2))
        yy = torch.matmul(cb[:, :, None] * decay, xdt)
        st = torch.matmul(xdt.transpose(-1, -2), brem)
        return yy, st

    # The least work: C B^T on and below the diagonal once per (batch,
    # chunk); per head the cumsum, the decay (subtract, exp), W, x dt,
    # the causal half of W (x dt), B (.) rem and the state product.
    tri_n = q * (q + 1) // 2
    flops = b * nc * (tri_n * 2 * n + h * (
        2 * q + 3 * tri_n + q * p + tri_n * 2 * p + q * n + 2 * q * n * p))
    nbytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + b_in.numel()
                  + c_in.numel() + got[1].numel() + got[2].numel())
    t_bound, by = bound(nbytes, flops)
    return {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_chunk/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk/kernel.py:61",
        "shape": f"x ({b}, {nc}, {q}, {h}, {p}), B/C ({b}, {nc}, {q}, {n}) "
                 f"f32",
        "max_abs_err": err,
        "ms": time_ms(lambda: ssd_chunk(*args)),
        "plain_ms": time_ms(lambda: ssd_chunk_plain(*args)),
        "library_ms": time_ms(products),
        "library": "torch.matmul chain of the three products only (C B^T, "
                   "(C B^T * decay) x dt, x dt^T (B * rem)) over a "
                   "precomputed decay, x dt and B * rem",
        "bound_ms": t_bound, "bound_by": by,
        "flops": flops, "bytes": nbytes, "err_vs_float64": err64,
    }


def phase_ssm_reference(torch, dev, target):
    """The chunked kernel path against the recurrence at full width: the
    logits of one ``forward`` over 2 x 100 tokens against 100
    ``decode_step`` calls from an empty cache at every position, and the
    last position against ``prefill`` of 99 tokens plus one
    ``decode_step``.  Tolerance 2e-3 absolute, the JAX test's."""
    from repro_torch.models import decode_step, forward, init_cache, prefill
    params, cfg = target
    toks = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)).to(dev)
    full = forward(params, cfg, {"tokens": toks})
    cache = init_cache(cfg, 2, 128, dev)
    err_rec = 0.0
    for i in range(100):
        lg, cache = decode_step(params, cfg, toks[:, i:i + 1], cache)
        err_rec = max(err_rec, float((lg - full[:, i]).abs().max()))
    last, pre = prefill(params, cfg, {"tokens": toks[:, :99]},
                        init_cache(cfg, 2, 128, dev))
    lg, _ = decode_step(params, cfg, toks[:, 99:], pre)
    err_pre = max(float((last - full[:, 98]).abs().max()),
                  float((lg - full[:, 99]).abs().max()))
    scale = float(full.abs().max())
    log(f"ssm reference: {cfg.name} {cfg.num_layers} layers, forward (the "
        f"ssd_chunk kernel) vs 100 decode steps (the recurrence): max abs "
        f"logit err {err_rec:.3g}; vs prefill(99) + decode: {err_pre:.3g} "
        f"(max |logit| {scale:.3g}, tolerance {SSM_LOGIT_TOL})")
    assert bool(torch.isfinite(full).all()), "non-finite logits"
    assert err_rec <= SSM_LOGIT_TOL, f"forward vs recurrence: {err_rec}"
    assert err_pre <= SSM_LOGIT_TOL, f"forward vs prefill+decode: {err_pre}"
    return err_rec, err_pre


def phase_ssm_serve(torch, dev, target, drafter, smi):
    from repro_torch import random as R
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    from repro_torch.launch import profile_reprefill as W
    vocab = target[1].vocab_size
    engine, server = W.make_server(target, drafter, dev)
    for p in W.workload_prompts(vocab, SEED):
        server.submit(p, max_new=W.MAX_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = server.run(R.PRNGKey(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = server.metrics
    assert len(done) == W.REQUESTS, f"{len(done)}/{W.REQUESTS} finished"
    for r in done:
        out = np.asarray(r.output)
        assert len(out) == W.MAX_NEW, f"uid {r.uid}: {len(out)} tokens"
        assert out.min() >= 0 and out.max() < vocab, f"uid {r.uid} range"
    per_round = drafter[1].num_layers * W.DRAFT_LEN + target[1].num_layers
    assert counts.get("ssd_chunk", 0) == per_round * m.rounds, \
        (counts, per_round, m.rounds)
    # One (L+1, K, vocab) race per request and block.
    blocks = sum(r.blocks for r in done)
    assert counts.get("gls_row_race", 0) == blocks, (counts, blocks)
    be = m.mean_block_efficiency
    log(f"ssm serve [{smi}]: {target[1].name} {target[1].num_layers}+"
        f"{drafter[1].num_layers} layers, reprefill batched, {len(done)} "
        f"requests, {m.total_tokens} tokens in {wall:.3f}s -> "
        f"{m.total_tokens / wall:.1f} tok/s; rounds={m.rounds} round wall "
        f"{wall / m.rounds * 1e3:.1f} ms block_efficiency={be:.3f} "
        f"ssd_chunk per round={counts.get('ssd_chunk', 0) / m.rounds:.0f} "
        f"gls_row_race={counts.get('gls_row_race', 0)} (= {blocks} request "
        f"blocks) "
        f"peak device memory {peak:.2f} GiB launches={counts}")
    return counts, {"wall_s": wall, "tokens": m.total_tokens,
                    "rounds": m.rounds, "block_efficiency": be,
                    "peak_gib": peak}


def phase_ssm_self_draft(torch, dev, target):
    from repro_torch import random as R
    from repro_torch.launch import profile_reprefill as W
    el = W.DRAFT_LEN
    engine, server = W.make_server(target, target, dev, max_batch=1)
    prompt = np.random.default_rng(SEED + 10).integers(
        0, target[1].vocab_size, 64).astype(np.int32)
    server.submit(prompt, max_new=4 * (el + 1))
    done = server.run(R.PRNGKey(SEED + 1))
    acc = sum(r.accepted for r in done) / max(sum(r.blocks for r in done), 1)
    log(f"ssm self-draft: blocks={server.metrics.rounds} mean accepted per "
        f"block={acc:.3f} (L={el}, need >= {0.9 * el:.1f})")
    assert server.metrics.rounds >= 3, server.metrics.rounds
    assert acc >= 0.9 * el, f"ssm self-draft acceptance {acc:.3f}"
    return acc


# ---------------------------------------------------------------------------
# Phase giants: decode at groups 48 and 16, the dense giants at full width
# ---------------------------------------------------------------------------


def giant_buf_len() -> int:
    """The giants' serve buffer: the longest prompt, the new tokens and
    L + 2 (``SpecDecServer._required_buf``)."""
    return GIANT_PROMPTS[1] + GIANT_MAX_NEW + L_DRAFT + 2


def phase_giant(torch, dev, arch: str, target_layers: int,
                draft_layers: int, smi: str):
    """One dense giant at its published widths, depth cut: the decode
    kernel's float32 and int8 instances at the model's group against
    plain at the serve shape (a group above 8: the group instance over
    either K/V type, held to float64, timed beside its floor and also
    over GIANT_LONG_T keys),
    the D = 128 flash instances at its admission shape against plain and
    float64 (as phase granite holds them); then the pair (target and
    drafter as separate trees, ``launch.serve.build_pair``) served
    kv_fused on the kernel routes, the same serve with the drafter's
    decode on its plain route (per-uid streams equal), and for
    granite-34b the same workload through kv (streams equal) and with
    ``quant=True``, on the kernel and the plain decode route (streams
    equal); the self-draft of one unit (4 prompts x 48 tokens)
    >= 0.9 L.  Gates: ``draft_syncs == 0``, ``host_syncs == rounds``,
    and exactly (L + 1) x drafter layers x rounds decode launches of the
    model's instance in each kv_fused serve.  Frees the pair (kernel
    records, launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_launch_name
    from repro_torch.launch.serve import build_pair
    cfg0 = get_config(arch).replace(num_layers=target_layers)
    buf = giant_buf_len()
    group = cfg0.num_heads // cfg0.kv_heads
    kernels = [kernel_decode(torch, dev, cfg0, buf, smi, GIANT_LONG_T),
               kernel_decode_int8(torch, dev, cfg0, buf, smi, GIANT_LONG_T)]
    for kr in kernels:
        log_kernel(kr, smi)
    for int8 in (False, True):
        kr = kernel_flash(torch, dev, cfg0, GIANT_PROMPTS[1], buf, int8)
        kr["shape"] += f", {arch}'s admission (group {group})"
        log_kernel(kr, smi)
    gc_collect(torch)
    t0 = time.perf_counter()
    target, drafter = build_pair(arch, draft_layers, SEED, dev,
                                 target_layers)
    torch.cuda.synchronize()
    n_params = [sum(x.numel() for x in _leaves(p)) for p, _ in
                (target, drafter)]
    log(f"giants: {arch} {target_layers}-layer target "
        f"({n_params[0] / 1e9:.3f}e9 parameters, "
        f"{4 * n_params[0] / 1e9:.2f} GB) and {draft_layers}-layer drafter "
        f"({n_params[1] / 1e9:.3f}e9, {4 * n_params[1] / 1e9:.2f} GB), "
        f"separate trees, head dim {cfg0.resolved_head_dim}, {group} query "
        f"heads per KV head, built in {time.perf_counter() - t0:.1f}s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated [{smi}]")
    kw = dict(requests=GIANT_REQUESTS, max_new=GIANT_MAX_NEW,
              prompts=GIANT_PROMPTS)
    counts, stats = phase_serve(torch, dev, target, drafter,
                                label=f"{arch} serve", **kw)
    decode = decode_launch_name(128, False, group)
    want = (L_DRAFT + 1) * draft_layers * stats["rounds"]
    assert counts.get(decode, 0) == want, (decode, counts, want)
    log(f"{arch}: {decode} launches {counts[decode]} = (L + 1) x "
        f"{draft_layers} drafter layers x {stats['rounds']} rounds; peak "
        f"device memory of the serve (the pair's weights included) "
        f"{stats['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated) "
        f"[{smi}]")
    gc_collect(torch)
    p_counts, plain = phase_serve(torch, dev, target, drafter,
                                  decode_kernel=False,
                                  label=f"{arch} serve, plain decode route",
                                  **kw)
    add_counts(counts, p_counts)
    same_streams(plain["streams"], stats["streams"],
                 f"{arch} kernel vs plain decode route")
    gc_collect(torch)
    if arch == "granite-34b":
        kv_counts, kv_stats = phase_serve(torch, dev, target, drafter,
                                          cache_mode="kv",
                                          label=f"{arch} kv serve", **kw)
        same_streams(stats["streams"], kv_stats["streams"],
                     f"{arch} kv vs kv_fused")
        compare_serves(kv_stats, stats, f"{arch} kv vs kv_fused serve", smi)
        add_counts(counts, kv_counts)
        gc_collect(torch)
        q_counts, q_stats = phase_serve(torch, dev, target, drafter,
                                        quant=True, label=f"{arch} serve",
                                        **kw)
        q_decode = decode_launch_name(128, True, group)
        assert q_counts.get(q_decode, 0) == \
            (L_DRAFT + 1) * draft_layers * q_stats["rounds"], \
            (q_counts, q_stats["rounds"])
        add_counts(counts, q_counts)
        log(f"{arch} quant vs float32 serve [{smi}]: "
            + ", ".join(f"{k} {q_stats[k]:.4g} vs {stats[k]:.4g}"
                        for k in ("tok_s", "round_ms", "ttft_ms", "peak_gib",
                                  "arena_mib")))
        gc_collect(torch)
        qp_counts, qp_stats = phase_serve(
            torch, dev, target, drafter, quant=True, decode_kernel=False,
            label=f"{arch} quant serve, plain decode route", **kw)
        add_counts(counts, qp_counts)
        same_streams(qp_stats["streams"], q_stats["streams"],
                     f"{arch} quant kernel vs plain decode route")
        compare_serves(q_stats, qp_stats,
                       f"{arch} quant serve, kernel vs plain decode route",
                       smi)
        gc_collect(torch)
    per_unit, _ = self_draft_rates(torch, dev, target, "float32", 1)
    acc = sum(a for a, _, _ in per_unit) / sum(b for _, b, _ in per_unit)
    log(f"{arch} self-draft: 1 unit x {S_SLOTS} prompts, mean accepted per "
        f"block {acc:.3f} (L={L_DRAFT}, need >= {0.9 * L_DRAFT:.1f})")
    assert acc >= 0.9 * L_DRAFT, f"{arch} self-draft acceptance {acc:.3f}"
    del target, drafter
    gc_collect(torch)
    return kernels, counts


# ---------------------------------------------------------------------------
# Phases moe and hybrid: the reference engine's other families
# ---------------------------------------------------------------------------


def phase_reprefill_serve(torch, dev, arch: str, target, drafter, smi):
    """``arch``'s reprefill workload (``profile_reprefill.WORKLOADS``)
    through the reference engine, batched: every request finishes with
    its tokens in range, one verify fetch and one ``gls_row_race`` launch
    per request and block, and no attention kernel (JAX's MoE and hybrid
    calls pass no ``use_kernel``)."""
    from repro_torch import random as R
    from repro_torch.kernels.mode import launch_counts, reset_launch_counts
    from repro_torch.launch import profile_reprefill as W
    _, _, _, requests, max_new, _, _ = W.WORKLOADS[arch]
    vocab = target[1].vocab_size
    _, server = W.make_server(target, drafter, dev, requests, arch)
    for p in W.workload_prompts(vocab, SEED, arch):
        server.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    done = server.run(R.PRNGKey(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = server.metrics
    assert len(done) == requests, f"{len(done)}/{requests} finished"
    for r in done:
        out = np.asarray(r.output)
        assert len(out) == max_new, f"uid {r.uid}: {len(out)} tokens"
        assert out.min() >= 0 and out.max() < vocab, f"uid {r.uid} range"
    blocks = sum(r.blocks for r in done)
    assert m.host_syncs == blocks, (m.host_syncs, blocks)
    assert counts.get("gls_row_race", 0) == blocks, (counts, blocks)
    assert set(counts) == {"gls_row_race"}, counts
    log(f"{arch} reprefill serve [{smi}]: {target[1].num_layers}+"
        f"{drafter[1].num_layers} layers, {len(done)} requests, "
        f"{m.total_tokens} tokens in {wall:.3f}s -> "
        f"{m.total_tokens / wall:.1f} tok/s; rounds={m.rounds} round wall "
        f"{wall / m.rounds * 1e3:.1f} ms block_efficiency="
        f"{m.mean_block_efficiency:.3f} host_syncs={m.host_syncs} "
        f"gls_row_race={counts.get('gls_row_race', 0)} (= {blocks} request "
        f"blocks) peak device memory {peak:.2f} GiB launches={counts}")
    return counts


def reprefill_self_draft(torch, dev, arch: str, target) -> float:
    """The target drafting for itself through the reference engine: one
    request of 64 tokens, 4 (L + 1) new; the mean accepted per block."""
    from repro_torch import random as R
    from repro_torch.launch import profile_reprefill as W
    el = W.WORKLOADS[arch][2]
    _, server = W.make_server(target, target, dev, 1, arch)
    prompt = np.random.default_rng(SEED + 10).integers(
        0, target[1].vocab_size, 64).astype(np.int32)
    server.submit(prompt, max_new=4 * (el + 1))
    done = server.run(R.PRNGKey(SEED + 1))
    acc = sum(r.accepted for r in done) / max(sum(r.blocks for r in done), 1)
    log(f"{arch} self-draft: blocks={server.metrics.rounds} mean accepted "
        f"per block {acc:.3f} (L={el})")
    return acc


def window_check(torch, dev, params, cfg, n_prefill: int, what: str):
    """``prefill`` of ``n_prefill`` tokens (past the window: the ring
    wraps, the attention is chunked) then ``WINDOW_DECODES``
    ``decode_step`` calls, against one full-sequence ``forward`` over all
    the tokens: the prefill's last logits and each step's, within
    SSM_LOGIT_TOL."""
    from repro_torch.models import decode_step, forward, init_cache, prefill
    n = n_prefill + WINDOW_DECODES
    toks = torch.from_numpy(np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
    full = forward(params, cfg, {"tokens": toks})[0]
    cache = init_cache(cfg, 1, n, dev)
    lg, cache = prefill(params, cfg, {"tokens": toks[:, :n_prefill]}, cache)
    errs = [float((lg[0] - full[n_prefill - 1]).abs().max())]
    for i in range(n_prefill, n):
        lg, cache = decode_step(params, cfg, toks[:, i:i + 1], cache)
        errs.append(float((lg[0] - full[i]).abs().max()))
    scale = float(full.abs().max())
    log(f"{what}: prefill({n_prefill}) + {WINDOW_DECODES} decode steps vs "
        f"forward({n}): max abs logit err {max(errs):.3g} (per step "
        f"{[float(f'{e:.3g}') for e in errs]}; max |logit| {scale:.3g}; "
        f"tolerance {SSM_LOGIT_TOL})")
    assert bool(torch.isfinite(full).all()), f"{what}: non-finite logits"
    assert max(errs) <= SSM_LOGIT_TOL, (what, errs)


def phase_moe(torch, dev, smi: str):
    """(a) granite-moe-1b-a400m at its published widths (24 layers, a
    2-layer drafter) through the reference engine; its self-draft rate is
    logged, not held: rows share routing groups and drops past capacity
    differ between the drafter's and the target's forwards, in JAX too.
    (b) mixtral-8x22b at its published widths, 2 layers, through the
    registry's cached calls past its 4,096-key window, against a forward
    over the whole sequence (lengths whose routing groups drop no token:
    ``MIXTRAL_PREFILL``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_pair
    from repro_torch.models import init_params
    from repro_torch.models import moe as M
    arch = "granite-moe-1b-a400m"
    target, drafter = build_pair(arch, 2, SEED, dev)
    counts = phase_reprefill_serve(torch, dev, arch, target, drafter, smi)
    reprefill_self_draft(torch, dev, arch, target)
    del target, drafter
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mixtral-8x22b").replace(num_layers=MIXTRAL_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_params(gen, cfg, dev)
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"mixtral-8x22b: {cfg.num_layers} layers at published widths "
        f"({n_params / 1e9:.3f}e9 parameters, {4 * n_params / 1e9:.2f} GB), "
        f"window {cfg.sliding_window}")
    n = MIXTRAL_PREFILL + WINDOW_DECODES
    assert max(M._group_size(MIXTRAL_PREFILL), M._group_size(n)) <= 2
    window_check(torch, dev, params, cfg, MIXTRAL_PREFILL,
                 "mixtral-8x22b cached calls")
    log(f"mixtral-8x22b: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    gc_collect(torch)
    return counts


def phase_hybrid(torch, dev, smi: str):
    """recurrentgemma-2b at its published widths (26 layers, a 3-layer
    drafter: one unit) through the reference engine, its self-draft
    >= 0.9 L; then the drafter's tree (one unit of the same widths) through
    the registry's cached calls past its 2,048-key window against a
    forward."""
    from repro_torch.launch import profile_reprefill as W
    from repro_torch.launch.serve import build_pair
    arch = "recurrentgemma-2b"
    target, drafter = build_pair(arch, 3, SEED, dev)
    n_params = [sum(x.numel() for x in _leaves(p)) for p, _ in
                (target, drafter)]
    log(f"{arch}: {target[1].num_layers}-layer target "
        f"({n_params[0] / 1e9:.3f}e9 parameters) and "
        f"{drafter[1].num_layers}-layer drafter ({n_params[1] / 1e9:.3f}e9)")
    counts = phase_reprefill_serve(torch, dev, arch, target, drafter, smi)
    acc = reprefill_self_draft(torch, dev, arch, target)
    el = W.WORKLOADS[arch][2]
    assert acc >= 0.9 * el, f"{arch} self-draft acceptance {acc:.3f}"
    gc_collect(torch)
    window_check(torch, dev, drafter[0], drafter[1], HYBRID_PREFILL,
                 f"{arch} (one unit) cached calls")
    del target, drafter
    gc_collect(torch)
    return counts


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_pair

    # Phase 1: environment and build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log("precision: allow_tf32 matmul=False cudnn=False, float32 matmul "
        "precision 'highest'")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.load_kernels(verbose=os.environ.get("CHIP_SMOKE_VERBOSE") == "1")
    log(f"phase build: {time.perf_counter() - t0:.1f}s")

    # Phase 2: kernels at the serving shapes.
    t0 = time.perf_counter()
    target, drafter = build_pair("smollm-360m", 4, SEED, dev)
    cfg = target[1]
    buf_len = PROMPT_MAX + MAX_NEW + L_DRAFT + 2
    kernels = [kernel_race(torch, dev, S_SLOTS * (L_DRAFT + 1),
                           cfg.vocab_size),
               kernel_decode(torch, dev, cfg, buf_len),
               kernel_flash(torch, dev, cfg, 256, buf_len),
               kernel_decode_int8(torch, dev, cfg, buf_len),
               kernel_flash(torch, dev, cfg, 256, buf_len, int8=True),
               kernel_binned(torch, dev, WZ_LMAX),
               kernel_joint(torch, dev, cfg.vocab_size)]
    binned_l2 = kernel_binned(torch, dev, 2)
    for kr in kernels + [binned_l2]:
        log_kernel(kr, smi)
    log(f"phase kernels: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_reference(torch, dev, target)
    log(f"phase reference: {time.perf_counter() - t0:.1f}s")

    # Phase 3: serve smollm-360m through all three kernels.
    t0 = time.perf_counter()
    counts, serve_stats = phase_serve(torch, dev, target, drafter)
    log(f"phase serve: {time.perf_counter() - t0:.1f}s")

    # Phase 3q: the same serve with int8 arenas and W8A8 verify.
    t0 = time.perf_counter()
    q_counts, q_stats = phase_serve(torch, dev, target, drafter, quant=True)
    for name in ("decode_attention_int8", "flash_attention_int8"):
        counts[name] = q_counts.get(name, 0)
    log(f"quant vs float32 serve [{smi}]: "
        + ", ".join(f"{k} {q_stats[k]:.4g} vs {serve_stats[k]:.4g}"
                    for k in ("tok_s", "round_ms", "ttft_ms", "peak_gib",
                              "arena_mib")))
    log(f"phase serve quant: {time.perf_counter() - t0:.1f}s")

    # Phase 4: self-draft acceptance check; 4q: quant against it.
    t0 = time.perf_counter()
    rate_f32, _ = phase_self_draft(torch, dev, target)
    phase_quant_self_draft(torch, dev, target, rate_f32)
    log(f"phase self-draft: {time.perf_counter() - t0:.1f}s")

    # Phase rs: SpecInfer, SpecTr and single-draft rejection sampling.
    t0 = time.perf_counter()
    phase_rs_verify(torch, dev, cfg.vocab_size)
    rs_stats = {}
    attn = ("decode_attention", "flash_attention")
    serve_attn = [counts[name] for name in attn]
    for strategy in ("gls",) + RS_STRATEGIES:
        rs_counts, rs_stats[strategy] = phase_rs_serve(
            torch, dev, target, drafter, strategy, smi)
        if strategy != "gls":
            for name in attn:
                counts[name] += rs_counts[name]
    log("launches (serve, rejection-sampling serves): " + ", ".join(
        f"{name} {n}, {counts[name] - n}" for name, n in zip(attn,
                                                             serve_attn)))
    log(f"rs serves against gls at the same workload [{smi}]: "
        + "; ".join(f"{st} " + ", ".join(f"{k} {v:.4g}" for k, v in
                                         sorted(rs_stats[st].items()))
                    for st in rs_stats)
        + f"; phase 3 gls (8 requests x 64 tokens): tok_s "
        f"{serve_stats['tok_s']:.4g}, round_ms {serve_stats['round_ms']:.4g}, "
        f"block_efficiency {serve_stats['block_efficiency']:.4g}")
    for strategy in RS_STRATEGIES:
        phase_rs_self_draft(torch, dev, target, strategy)
    log(f"phase rs: {time.perf_counter() - t0:.1f}s")

    # Phase kv: the host-driven round and per-request admission.
    t0 = time.perf_counter()
    kv_counts = phase_kv(torch, dev, target, drafter, serve_stats, smi)
    log(f"phase kv: {time.perf_counter() - t0:.1f}s")

    # Phase paged: the paged arena and the v2 policy.
    t0 = time.perf_counter()
    paged_counts = phase_paged(torch, dev, target, drafter, smi)
    log(f"phase paged: {time.perf_counter() - t0:.1f}s")

    # Phase dense: the dense serving calls and chunked attention.
    t0 = time.perf_counter()
    phase_dense_calls(torch, dev, target)
    log(f"phase dense: {time.perf_counter() - t0:.1f}s")

    # Phase diverse: heterogeneous drafters in the reference engine.
    t0 = time.perf_counter()
    diverse_counts = phase_diverse(torch, dev, target, drafter, smi)
    log(f"phase diverse: {time.perf_counter() - t0:.1f}s")
    log("launches of phases kv, paged and diverse (added to the kernels "
        f"line): kv {kv_counts}, paged {paged_counts}, diverse "
        f"{diverse_counts}")
    add_counts(counts, kv_counts)
    add_counts(counts, diverse_counts)
    add_counts(counts, paged_counts)
    # One pair on the card at a time from here on.
    del target, drafter
    gc_collect(torch)

    # Phase granite: granite-8b (head dim 128) through kv_fused.
    t0 = time.perf_counter()
    g_kernels, g_counts = phase_granite(torch, dev, smi, buf_len)
    kernels[5:5] = g_kernels
    for kr in g_kernels:
        counts[kr["name"]] = g_counts.get(kr["name"], 0)
    log(f"gls_row_race launches: smollm serves {counts['gls_row_race']}, "
        f"granite kv_fused and kv serves {g_counts.get('gls_row_race', 0)}")
    counts["gls_row_race"] += g_counts.get("gls_row_race", 0)
    log(f"phase granite: {time.perf_counter() - t0:.1f}s")

    # Phase giants: granite-34b (group 48) and llama3-405b (group 16)
    # through kv_fused on the decode kernel's group instance.
    giant_kernels = []
    for arch, target_layers, draft_layers in GIANTS:
        t0 = time.perf_counter()
        gk, gcounts = phase_giant(torch, dev, arch, target_layers,
                                  draft_layers, smi)
        giant_kernels += gk
        log(f"launches of {arch}'s serves (added to the kernels line): "
            f"{gcounts}")
        add_counts(counts, gcounts)
        log(f"phase giants ({arch}): {time.perf_counter() - t0:.1f}s")
    kernels[9:9] = giant_kernels
    # The int8 instance at group 16 has no serve: llama3-405b serves
    # float32 only (its W8A8 verify copy would not fit beside the pair).
    for kr in giant_kernels:
        if kr["name"] != "decode_attention_int8_d128_g16":
            assert counts.get(kr["name"], 0) > 0, (kr["name"], counts)

    # Phases moe and hybrid: the reference engine's MoE and RG-LRU
    # families, and their windows' cached calls.
    for name, phase in (("moe", phase_moe), ("hybrid", phase_hybrid)):
        t0 = time.perf_counter()
        fam_counts = phase(torch, dev, smi)
        log(f"launches of phase {name}'s serve (added to the kernels "
            f"line): {fam_counts}")
        add_counts(counts, fam_counts)
        log(f"phase {name}: {time.perf_counter() - t0:.1f}s")

    # Phase 5: Wyner-Ziv compression through the binned race kernel.
    t0 = time.perf_counter()
    wz_counts, _ = phase_compress(torch, dev)
    counts["gls_binned_race"] = wz_counts.get("gls_binned_race", 0)
    phase_fig2(torch, dev)
    log(f"phase compress: {time.perf_counter() - t0:.1f}s")

    # Phase 6: the joint race against Algorithm 1.
    t0 = time.perf_counter()
    counts["gls_race"] = phase_gls(torch, dev).get("gls_race", 0)
    log(f"phase gls: {time.perf_counter() - t0:.1f}s")

    # Phase 7: Mamba-2 through the reference engine and ssd_chunk.
    t0 = time.perf_counter()
    from repro_torch.launch import profile_reprefill as W
    ssm_target, ssm_drafter = build_pair(W.ARCH, W.DRAFT_LAYERS, SEED, dev)
    # The row race at the shape this path gives it: one request's block.
    kr = kernel_race(torch, dev, W.DRAFT_LEN + 1, ssm_target[1].vocab_size)
    kr["shape"] += ", the reprefill verifier; bitwise equal to plain"
    log_kernel(kr, smi)
    kr = kernel_ssd(torch, dev, ssm_target[1])
    log_kernel(kr, smi)
    kernels.append(kr)
    phase_ssm_reference(torch, dev, ssm_target)
    ssm_counts, _ = phase_ssm_serve(torch, dev, ssm_target, ssm_drafter, smi)
    counts["ssd_chunk"] = ssm_counts.get("ssd_chunk", 0)
    # The row race serves both paths: its launches are the sum.
    log(f"gls_row_race launches: kv_fused serves {counts['gls_row_race']}, "
        f"reprefill serve {ssm_counts.get('gls_row_race', 0)}")
    counts["gls_row_race"] += ssm_counts.get("gls_row_race", 0)
    phase_ssm_self_draft(torch, dev, ssm_target)
    del ssm_target, ssm_drafter
    log(f"phase ssm: {time.perf_counter() - t0:.1f}s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; total {time.perf_counter() - t_start:.1f}s")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for kr in kernels:
        kr["launches"] = int(counts.get(kr["name"], 0))
    print(json.dumps({"kernels": [{k: kr[k] for k in keys + (
        "device_ms", "floor_ms", "bound_fma_ms") if k in kr}
        for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
