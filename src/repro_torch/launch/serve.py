"""Serving launcher of the port: multi-draft speculative decoding over
a target/drafter pair at a registered architecture's published widths,
driven by the FIFO scheduler, with fused rounds over KV caches
(``--cache-mode kv_fused``, dense models), host-driven rounds over the
same caches (``--cache-mode kv``), or through the reference engine that
re-scores the whole prefix every block (``--cache-mode reprefill``,
required for the SSM, MoE and hybrid families, batched over live
requests).

  python -m repro_torch.launch.serve --arch smollm-360m --draft-layers 4 \
      --requests 8 --drafts 8 --draft-len 4 --seed 0 [--device cpu]
  python -m repro_torch.launch.serve --arch mamba2-370m \
      --cache-mode reprefill --draft-layers 4 --requests 4 --max-new 32
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --cache-mode reprefill --draft-layers 2 --requests 4 --max-new 16
  python -m repro_torch.launch.serve --arch granite-34b \
      --target-layers 16 --draft-layers 2 --requests 4 --max-new 16
  python -m repro_torch.launch.serve --cache-mode kv \
      --admission per_request
  python -m repro_torch.launch.serve --paged --policy v2 \
      --preempt-tokens 8 [--cache-mode kv]

Both models are initialised from ``--seed`` with the port's own
generator (no checkpoint is read).  The drafter has the target's widths
and ``--draft-layers`` layers; ``--target-layers`` cuts the target's
depth (widths stay).  Prompts of 16..128 tokens are drawn from the
seed.  Any of the six verification strategies at top-k 50 (single and
daliri with one draft); under kv and kv_fused the decode and prefill
attention kernels are on (per-request admission prefills through the
dense ``prefill``, as JAX's does), under reprefill an SSM model's
forwards run the ``ssd_chunk`` kernel.  ``--admission`` picks the
cached engine's prefill path (bucketed waves, or per request).
``--paged`` serves from the paged KV arena (pages of 64 tokens, grown on
demand) and ``--policy v2`` schedules with priorities, eviction and
``--preempt-tokens`` rotation (both kv and kv_fused only).
``--backend legacy`` (the per-token host loop) runs under reprefill and
kv.  Runs on the card unless ``--device cpu``.  Prints the JAX
launcher's summary fields.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.specdec import (
    BACKENDS,
    STRATEGIES,
    CachedSpecDecEngine,
    SpecDecConfig,
    SpecDecEngine,
    SpecDecServer,
)
from repro_torch.specdec.scheduler import (ADMISSION_MODES, CACHE_MODES,
                                          POLICIES)


def build_pair(arch: str, draft_layers: int, seed: int, device,
               target_layers: Optional[int] = None):
    """(target, drafter) as ``(params, cfg)`` pairs on ``device``, drawn
    from ``seed`` (target) and ``seed + 1`` (drafter) through the
    family registry's ``init_params``."""
    device = resolve_device(device)
    t_cfg = get_config(arch)
    if target_layers:
        t_cfg = t_cfg.replace(num_layers=target_layers)
    d_cfg = t_cfg.replace(name=t_cfg.name + "-drafter",
                          num_layers=draft_layers)
    pair = []
    for cfg, s in ((t_cfg, seed), (d_cfg, seed + 1)):
        gen = torch.Generator(device=device)
        gen.manual_seed(s)
        pair.append((init_params(gen, cfg, device), cfg))
    return tuple(pair)


def draw_prompts(n: int, vocab: int, min_len: int, max_len: int,
                 seed: int) -> list:
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(0, vocab, size=int(ln)).astype(np.int32)
            for ln in lens]


def check_cache_mode(arch: str, cache_mode: str) -> None:
    """The cached engines serve the dense family only (as in JAX, whose
    ``engine_cached.py`` asserts it); the ssm, moe and hybrid families
    need reprefill.  No engine serves encdec or vlm: their ``forward``
    needs frames or images, and the engines pass tokens only, as JAX's
    do."""
    family = get_config(arch).family
    if family in ("encdec", "vlm"):
        raise ValueError(
            f"--arch {arch} is an {family} model: no serving engine passes "
            "its frames or images")
    if cache_mode != "reprefill" and family != "dense":
        raise ValueError(
            f"--arch {arch} is a {family} model: the {cache_mode} engine "
            "serves dense models only; use --cache-mode reprefill")


def summary(args, server, done, engine) -> str:
    m = server.metrics
    be = float(np.mean([r.block_efficiency for r in done])) if done else 0.0
    ttft = float(np.mean([r.ttft_ms for r in done])) if done else 0.0
    dispatches = getattr(engine, "num_prefill_dispatches", 0)
    return (f"strategy={args.strategy} K={engine.cfg.num_drafts} "
            f"L={args.draft_len} backend={args.backend} "
            f"cache_mode={args.cache_mode} "
            f"admission={args.admission} BE={be:.2f} "
            f"tok/s={m.tokens_per_s:.1f} "
            f"mean-ttft={ttft:.1f}ms "
            f"prefill-dispatches={dispatches} "
            f"rounds={m.rounds} target-forwards={m.target_forwards} "
            f"verify-syncs={m.host_syncs} draft-syncs={m.draft_syncs} "
            f"evictions={m.evictions} preemptions={m.preemptions} "
            f"over {len(done)} requests")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_NAMES)
    ap.add_argument("--cache-mode", default="kv_fused", choices=CACHE_MODES,
                    help="kv_fused: fused rounds over KV caches (dense); "
                         "kv: host-driven rounds over the same caches; "
                         "reprefill: the reference engine, batched "
                         "(required for ssm)")
    ap.add_argument("--admission", default="bucketed",
                    choices=ADMISSION_MODES,
                    help="cached-engine prefill: bucketed waves of "
                         "stacked slot prefills, or per_request dense "
                         "prefills (kv and kv_fused)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV arena: fixed-size time pages behind a "
                         "page table; preemption parks pages instead of "
                         "discarding KV (kv/kv_fused only)")
    ap.add_argument("--policy", default="fifo", choices=POLICIES,
                    help="v2: priority-ordered admission with eviction, "
                         "re-admission and preemption (kv/kv_fused only)")
    ap.add_argument("--preempt-tokens", type=int, default=None,
                    help="rotation quantum: suspend a request after this "
                         "many new tokens while others wait (policy v2)")
    ap.add_argument("--draft-layers", type=int, default=4)
    ap.add_argument("--target-layers", type=int, default=None,
                    help="cut the target's depth (default: published)")
    ap.add_argument("--strategy", default="gls", choices=STRATEGIES)
    ap.add_argument("--drafts", type=int, default=8)
    ap.add_argument("--draft-len", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--backend", default="kernel", choices=BACKENDS,
                    help="block-verification backend (kernel: the "
                         "gls_row_race CUDA kernel for the race family; "
                         "legacy: the per-token host loop, reprefill or "
                         "kv)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    return ap


def serve(args):
    """Build the pair, serve the requests; returns (server, done, engine)."""
    check_cache_mode(args.arch, args.cache_mode)
    device = resolve_device(args.device)
    target, drafter = build_pair(args.arch, args.draft_layers, args.seed,
                                 device, args.target_layers)
    k = 1 if args.strategy in ("single", "daliri") else args.drafts
    cached = args.cache_mode != "reprefill"
    cfg = SpecDecConfig(num_drafts=k, draft_len=args.draft_len,
                        strategy=args.strategy, top_k=50,
                        max_new_tokens=args.max_new,
                        verifier_backend=args.backend,
                        decode_kernel=cached, prefill_kernel=cached,
                        paged=args.paged)
    if cached:
        engine = CachedSpecDecEngine(target, drafter, cfg,
                                     pool_slots=args.max_batch,
                                     device=device)
        server = SpecDecServer(engine, max_batch=args.max_batch,
                               cache_mode=args.cache_mode,
                               admission=args.admission,
                               policy=args.policy,
                               preempt_tokens=args.preempt_tokens)
    else:
        engine = SpecDecEngine(target, drafter, cfg, device=device)
        server = SpecDecServer(engine, max_batch=args.max_batch,
                               cache_mode="reprefill")
    for p in draw_prompts(args.requests, target[1].vocab_size, 16, 128,
                          args.seed):
        server.submit(p, max_new=args.max_new)
    done = server.run(R.PRNGKey(args.seed))
    return server, done, engine


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.cache_mode == "kv_fused" and args.backend == "legacy":
        ap.error("--cache-mode kv_fused needs a device verifier backend "
                 "(torch or kernel)")
    if (args.paged or args.policy == "v2") and \
            args.cache_mode not in ("kv", "kv_fused"):
        ap.error("--paged / --policy v2 need --cache-mode kv or kv_fused")
    server, done, engine = serve(args)
    print(summary(args, server, done, engine))


if __name__ == "__main__":
    main()
