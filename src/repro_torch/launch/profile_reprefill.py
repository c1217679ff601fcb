"""Where a reprefill serving round of Mamba-2 spends its time on the card.

  python -m repro_torch.launch.profile_reprefill [--rounds 4] \
      [--trace build/profile_reprefill_trace.json]

Serves mamba2-370m at its published widths with the reprefill workload
that ``chip_smoke.py``'s ssm phase also drives (``make_server``,
``workload_prompts``): a 48-layer target and a 4-layer drafter of the
same widths, float32, weights from seeds 0 and 1; 4 requests x 8 drafts
x 4 draft tokens, GLS, top-k 50, the kernel verifier, through
``SpecDecServer(cache_mode="reprefill")`` (batched): 4 prompts of
64-192 tokens, the longest 192, so the buffer is 230 tokens (4 chunks
of 64).  After ``--warmup`` rounds it steps ``--rounds`` rounds under
``torch.profiler`` (CPU and CUDA activities) and prints, per round:

* wall time on the host clock (each round ends in host fetches, so the
  device has finished the round's work), device busy time and the
  device's idle share, kernel launches and the synchronising runtime
  calls (``profile_round.analyse``);
* host and device ms of the engine's ``block/<phase>`` ranges: the
  shared uniforms, the L-step drafter sweep, the target forward and the
  per-request verification;
* the device time of the top kernels and ``ssd_chunk``'s share of the
  device time.

The last line is a JSON object with the same numbers.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.launch.profile_round import analyse
from repro_torch.launch.serve import build_pair, draw_prompts
from repro_torch.specdec import SpecDecConfig, SpecDecEngine, SpecDecServer

# The reprefill workload: model pair, speculation and traffic.
ARCH, DRAFT_LAYERS = "mamba2-370m", 4
DRAFTS, DRAFT_LEN, TOP_K = 8, 4, 50
REQUESTS, MAX_NEW, PROMPT_MIN, PROMPT_MAX = 4, 32, 64, 192


def make_server(target, drafter, dev, max_batch: int = REQUESTS):
    """A reprefill ``SpecDecServer`` over a ``SpecDecEngine`` with GLS,
    ``DRAFTS`` x ``DRAFT_LEN``, top-k ``TOP_K`` and the kernel
    verifier.  Returns (engine, server)."""
    cfg = SpecDecConfig(num_drafts=DRAFTS, draft_len=DRAFT_LEN,
                        strategy="gls", top_k=TOP_K, max_new_tokens=MAX_NEW,
                        verifier_backend="kernel")
    engine = SpecDecEngine(target, drafter, cfg, device=dev)
    return engine, SpecDecServer(engine, max_batch=max_batch,
                                 cache_mode="reprefill")


def workload_prompts(vocab: int, seed: int) -> list:
    """``REQUESTS`` prompts of ``PROMPT_MIN``-``PROMPT_MAX`` tokens; the
    first is exactly ``PROMPT_MAX`` long, so the longest prompt -- and
    with it the buffer and ``ssd_chunk``'s shape -- is the same for every
    seed."""
    prompts = draw_prompts(REQUESTS, vocab, PROMPT_MIN, PROMPT_MAX, seed)
    prompts[0] = np.random.default_rng(seed + 9).integers(
        0, vocab, PROMPT_MAX).astype(np.int32)
    return prompts


def buffer_len() -> int:
    """The reprefill buffer of the workload: the longest prompt, the new
    tokens and L + 2 (``SpecDecServer._required_buf``)."""
    return PROMPT_MAX + MAX_NEW + DRAFT_LEN + 2


def kernel_ms(trace: dict, needle: str, rounds: int) -> float:
    """Device ms per round of the kernels whose name contains
    ``needle``."""
    return sum(e["dur"] for e in trace.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and needle in str(e.get("name", ""))) / 1e3 / rounds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=os.path.join(
        "build", "profile_reprefill_trace.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_reprefill needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    target, drafter = build_pair(ARCH, DRAFT_LAYERS, args.seed, dev)
    _, server = make_server(target, drafter, dev)
    assert args.warmup + args.rounds <= MAX_NEW
    for p in workload_prompts(target[1].vocab_size, args.seed):
        server.submit(p, max_new=MAX_NEW)
    key = R.PRNGKey(args.seed)
    for _ in range(args.warmup):
        server.step(key)
    torch.cuda.synchronize()
    assert len(server.live) == REQUESTS and not server.queue
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
        trace = json.load(f)
    res = analyse(trace, args.rounds, prefix="block/")
    wall = float(np.mean(walls))
    busy = res["device_busy_ms_per_round"]
    ssd = kernel_ms(trace, "ssd_chunk", args.rounds)
    res.update(wall_ms_per_round=wall, wall_ms_rounds=walls,
               device_idle_share=1.0 - busy / wall,
               ssd_chunk_ms_per_round=ssd,
               ssd_chunk_share_of_device=ssd / busy,
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print(f"rounds={args.rounds} wall={wall:.2f} ms/round "
          f"device_busy={busy:.2f} ms/round "
          f"idle_share={res['device_idle_share']:.3f} "
          f"launches={res['launches_per_round']:.0f}/round "
          f"sync_calls={res['sync_calls_per_round']} outside the rounds "
          f"{res['sync_calls_outside_rounds']}")
    for name, ph in res["phases"].items():
        print(f"  {name:<22} host {ph['host_ms']:8.3f} ms  device "
              f"{ph['device_ms']:8.3f} ms")
    print(f"  ssd_chunk {ssd:8.3f} ms/round = "
          f"{res['ssd_chunk_share_of_device']:.3f} of device time")
    for name, ms in res["top_kernels_ms_per_round"].items():
        print(f"  kernel {ms:8.3f} ms  {name}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
