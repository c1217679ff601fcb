"""Where a fused (or host-driven kv) serving round spends its time on
the card.

  python -m repro_torch.launch.profile_round [--arch smollm-360m] \
      [--target-layers N] [--draft-layers 4] \
      [--rounds 6] [--quant] [--strategy gls] [--cache-mode kv_fused] \
      [--paged] [--trace build/profile_round_trace.json]

Serves a dense model (``--arch``: smollm-360m by default, granite-8b,
or a giant, granite-34b or llama3-405b, with ``--target-layers`` and
``--draft-layers`` cutting its depth as ``chip_smoke.py``'s phase giants
does: 16 + 2 and 2 + 1)
at its published widths with the serving geometry of ``chip_smoke.py``
(the full-depth target, a 4-layer drafter of the same widths, 4 slots x
8 drafts x 4 draft tokens, the kernel verifier and both attention
kernels, float32; ``--strategy``: the verification strategy, GLS by default, one
draft for single and daliri; ``--quant``: int8 KV arenas and the W8A8
verify chunk of ``SpecDecConfig(quant=True)``; ``--cache-mode kv``: the
host-driven round, whose phases carry the same ``round/<phase>``
names; ``--paged``: the paged KV arena, pages of 64 tokens, where the
kv_fused round runs on its persistent contiguous view and the kv round
gathers and scatters each layer's view around every model call inside
the same phases), fills all four slots,
warms up, then
steps ``--rounds`` rounds
with no admission inside the window under ``torch.profiler`` (CPU and
CUDA activities).  From the exported Chrome trace it prints, per round:

* wall time on the host clock (each round ends in its packed fetch, or
  in the kv round's last verification fetch, so the device has finished
  the round's work up to the rollback and the catch-up);
* device busy time (union of kernel / memcpy / memset intervals) and
  the device's idle share of the wall time;
* kernel launches, and the host's synchronising runtime calls inside
  the rounds (each ``server.step`` runs under a ``serve/step`` range)
  and outside them (``torch.profiler``'s own exit synchronises the
  device once while it still traces);
* for each ``round/<phase>`` profiler range of the engine: its host time
  and the device time of the kernels it launched (matched through the
  launch's correlation id);
* the device time of the top kernels by name, the ported kernels among
  them.

The last line is a JSON object with the same numbers.  Needs the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.serve import build_pair
from repro_torch.specdec import STRATEGIES, CachedSpecDecEngine
from repro_torch.specdec import SpecDecConfig, SpecDecServer

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The kv_fused engine serves the dense family only.
DENSE_ARCHS = tuple(a for a in ARCH_NAMES
                    if get_config(a).family == "dense")


def _union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def analyse(trace: dict, rounds: int, prefix: str = "round/",
            step: str = "serve/step") -> dict:
    """Per-step numbers of a Chrome trace of ``rounds`` steps, each under
    a ``step`` range, with phase ranges named ``prefix<phase>``."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(prefix)
              and e.get("name") != step]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") == step]
    # cuBLAS launches its GEMMs through the driver API (category
    # "cuda_driver"); a match on "cuda_runtime" alone left them out of
    # every phase.
    launches = {e["args"].get("correlation"): e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "args" in e}
    busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    by_name = collections.Counter()
    for e in device:
        by_name[e["name"]] += e["dur"]
    phase_host = collections.Counter()
    for r in ranges:
        phase_host[r["name"]] += r["dur"]
    phase_dev = collections.Counter()
    spans = sorted((r["ts"], r["ts"] + r["dur"], r["name"]) for r in ranges)
    for e in device:
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for s, t_end, name in spans:
            if s <= ts <= t_end:
                phase_dev[name] += e["dur"]
                break
    kernels = [e for e in device if e.get("cat") == "kernel"]
    # Host-side waits on the device: the round's packed fetch is one
    # copy and one stream synchronisation; any more is a hidden sync.
    syncs, syncs_outside = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") == "cuda_runtime" and (
                "Synchronize" in e["name"] or e["name"] == "cudaMemcpy"):
            inside = any(s <= e["ts"] <= t for s, t in steps)
            (syncs if inside else syncs_outside)[e["name"]] += 1
    return {
        "device_busy_ms_per_round": busy_us / 1e3 / rounds,
        "launches_per_round": len(kernels) / rounds,
        "sync_calls_per_round": {n: c / rounds for n, c in syncs.items()},
        "sync_calls_outside_rounds": dict(syncs_outside),
        "phases": {name: {"host_ms": phase_host[name] / 1e3 / rounds,
                          "device_ms": phase_dev[name] / 1e3 / rounds}
                   for name in sorted(phase_host)},
        "top_kernels_ms_per_round": {
            name[:80]: us / 1e3 / rounds
            for name, us in by_name.most_common(12)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m", choices=DENSE_ARCHS)
    ap.add_argument("--target-layers", type=int, default=None,
                    help="cut the target's depth (default: published)")
    ap.add_argument("--draft-layers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="gls", choices=STRATEGIES)
    ap.add_argument("--quant", action="store_true",
                    help="int8 KV arenas and W8A8 verify")
    ap.add_argument("--cache-mode", default="kv_fused",
                    choices=("kv_fused", "kv"),
                    help="the fused round or the host-driven one")
    ap.add_argument("--paged", action="store_true",
                    help="the paged KV arena (SpecDecConfig.paged)")
    ap.add_argument("--trace", default=os.path.join(
        "build", "profile_round_trace.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    target, drafter = build_pair(args.arch, args.draft_layers, args.seed,
                                 dev, args.target_layers)
    k = 1 if args.strategy in ("single", "daliri") else 8
    cfg = SpecDecConfig(num_drafts=k, draft_len=4, strategy=args.strategy,
                        top_k=50, verifier_backend="kernel",
                        decode_kernel=True, prefill_kernel=True,
                        quant=args.quant, paged=args.paged)
    engine = CachedSpecDecEngine(target, drafter, cfg, pool_slots=4,
                                 device=dev)
    server = SpecDecServer(engine, max_batch=4, cache_mode=args.cache_mode)
    rng = np.random.default_rng(args.seed)
    budget = (args.warmup + args.rounds + 2) * (cfg.draft_len + 1)
    for n in (64, 128, 200, 300):
        server.submit(rng.integers(0, target[1].vocab_size, n).astype(
            np.int32), max_new=budget)
    key = R.PRNGKey(args.seed)
    for _ in range(args.warmup):
        server.step(key)
    torch.cuda.synchronize()
    assert len(server.live) == 4 and not server.queue
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            with torch.profiler.record_function("serve/step"):
                server.step(key)
            walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        res = analyse(json.load(f), args.rounds)
    wall = float(np.mean(walls))
    res.update(wall_ms_per_round=wall, wall_ms_rounds=walls,
               device_idle_share=1.0 - res["device_busy_ms_per_round"] / wall,
               quant=args.quant, strategy=args.strategy, arch=args.arch,
               cache_mode=args.cache_mode, paged=args.paged,
               device=torch.cuda.get_device_name(0))
    print(f"arch={args.arch} strategy={args.strategy} quant={args.quant} "
          f"cache_mode={args.cache_mode} paged={args.paged} "
          f"rounds={args.rounds} wall={wall:.2f} ms/round "
          f"device_busy={res['device_busy_ms_per_round']:.2f} ms/round "
          f"idle_share={res['device_idle_share']:.3f} "
          f"launches={res['launches_per_round']:.0f}/round "
          f"sync_calls={res['sync_calls_per_round']} outside the rounds "
          f"{res['sync_calls_outside_rounds']}")
    for name, ph in res["phases"].items():
        print(f"  {name:<20} host {ph['host_ms']:8.3f} ms  device "
              f"{ph['device_ms']:8.3f} ms")
    for name, ms in res["top_kernels_ms_per_round"].items():
        print(f"  kernel {ms:8.3f} ms  {name}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
