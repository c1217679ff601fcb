"""Where a reprefill serving round spends its time on the card.

  python -m repro_torch.launch.profile_reprefill [--rounds 4] \
      [--arch mamba2-370m|granite-moe-1b-a400m|recurrentgemma-2b] \
      [--trace build/profile_reprefill_trace.json]

Serves mamba2-370m at its published widths with the reprefill workload
that ``chip_smoke.py``'s ssm phase also drives (``make_server``,
``workload_prompts``): a 48-layer target and a 4-layer drafter of the
same widths, float32, weights from seeds 0 and 1; 4 requests x 8 drafts
x 4 draft tokens, GLS, top-k 50, the kernel verifier, through
``SpecDecServer(cache_mode="reprefill")`` (batched): 4 prompts of
64-192 tokens, the longest 192, so the buffer is 230 tokens (4 chunks
of 64).  ``--arch`` takes the other families the reference engine
serves, each with its own workload (``WORKLOADS``): granite-moe-1b-a400m
(24 layers, a 2-layer drafter, 8 drafts x 4, prompts 16-128, 16 new
tokens) and recurrentgemma-2b (26 layers, a 3-layer drafter: one unit,
4 drafts x 2, prompts 32-96, 16 new tokens), as ``chip_smoke.py``'s
phases moe and hybrid serve them.  After ``--warmup`` rounds it steps
``--rounds`` rounds under
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

# The reprefill workloads by arch: drafter layers, drafts, draft length,
# requests, new tokens, shortest and longest prompt.  Mamba-2's names
# below are the module's defaults.
WORKLOADS = {
    "mamba2-370m": (4, 8, 4, 4, 32, 64, 192),
    "granite-moe-1b-a400m": (2, 8, 4, 4, 16, 16, 128),
    "recurrentgemma-2b": (3, 4, 2, 4, 16, 32, 96),
}
ARCH = "mamba2-370m"
(DRAFT_LAYERS, DRAFTS, DRAFT_LEN, REQUESTS, MAX_NEW, PROMPT_MIN,
 PROMPT_MAX) = WORKLOADS[ARCH]
TOP_K = 50


def make_server(target, drafter, dev, max_batch: int = REQUESTS,
                arch: str = ARCH):
    """A reprefill ``SpecDecServer`` over a ``SpecDecEngine`` with GLS,
    ``arch``'s drafts x draft length, top-k ``TOP_K`` and the kernel
    verifier.  Returns (engine, server)."""
    _, drafts, draft_len, _, max_new, _, _ = WORKLOADS[arch]
    cfg = SpecDecConfig(num_drafts=drafts, draft_len=draft_len,
                        strategy="gls", top_k=TOP_K, max_new_tokens=max_new,
                        verifier_backend="kernel")
    engine = SpecDecEngine(target, drafter, cfg, device=dev)
    return engine, SpecDecServer(engine, max_batch=max_batch,
                                 cache_mode="reprefill")


def workload_prompts(vocab: int, seed: int, arch: str = ARCH) -> list:
    """``arch``'s requests, prompts of its shortest to longest length;
    the first is exactly the longest, so the longest prompt -- and with
    it the buffer and the kernels' shapes -- is the same for every
    seed."""
    _, _, _, requests, _, lo, hi = WORKLOADS[arch]
    prompts = draw_prompts(requests, vocab, lo, hi, seed)
    prompts[0] = np.random.default_rng(seed + 9).integers(
        0, vocab, hi).astype(np.int32)
    return prompts


def buffer_len(arch: str = ARCH) -> int:
    """The reprefill buffer of the workload: the longest prompt, the new
    tokens and L + 2 (``SpecDecServer._required_buf``)."""
    _, _, draft_len, _, max_new, _, hi = WORKLOADS[arch]
    return hi + max_new + draft_len + 2


def kernel_ms(trace: dict, needle: str, rounds: int) -> float:
    """Device ms per round of the kernels whose name contains
    ``needle``."""
    return sum(e["dur"] for e in trace.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and needle in str(e.get("name", ""))) / 1e3 / rounds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCH, choices=sorted(WORKLOADS))
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
    draft_layers, _, _, requests, max_new, _, _ = WORKLOADS[args.arch]
    target, drafter = build_pair(args.arch, draft_layers, args.seed, dev)
    _, server = make_server(target, drafter, dev, requests, args.arch)
    assert args.warmup + args.rounds <= max_new
    for p in workload_prompts(target[1].vocab_size, args.seed, args.arch):
        server.submit(p, max_new=max_new)
    key = R.PRNGKey(args.seed)
    for _ in range(args.warmup):
        server.step(key)
    torch.cuda.synchronize()
    assert len(server.live) == requests and not server.queue
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
