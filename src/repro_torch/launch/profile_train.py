"""Where a training step spends its time on the card.

  python -m repro_torch.launch.profile_train [--arch smollm-360m] \\
      [--steps 3] [--warmup 2] [--trace build/profile_train_trace.json]

Trains ``--arch`` (smollm-360m or mamba2-370m) at its published widths,
float32, weights from ``--seed``, on ``chip_smoke.py`` phase train's
workload: batch 8 x seq 128 from ``data.lm_dataset``, ``make_train_step``
with remat.  After ``--warmup`` steps it runs ``--steps`` steps under
``torch.profiler`` (CPU and CUDA activities) and prints, per step:

* wall time on the host clock (each step ends in a synchronise), device
  busy time and the device's idle share, kernel launches and the
  synchronising runtime calls (``profile_round.analyse``);
* host and device ms of the step's two halves, ``train/loss_grad`` (the
  forward, its recomputation and the backward) and ``train/adam`` (the
  schedule, clipping and the AdamW update);
* the device time of the top kernels and ``ssd_chunk``'s.

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

from repro_torch.configs import get_config
from repro_torch.data import lm_dataset
from repro_torch.device import to_device
from repro_torch.launch.profile_reprefill import kernel_ms
from repro_torch.launch.profile_round import analyse
from repro_torch.models import init_params
from repro_torch.optim import adam_init
from repro_torch.train import TrainConfig, make_train_step

ARCHS = ("smollm-360m", "mamba2-370m")
BATCH, SEQ = 8, 128


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCHS[0], choices=ARCHS)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=os.path.join(
        "build", "profile_train_trace.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg, dev)
    opt = adam_init(params)
    total = args.warmup + args.steps
    step_fn = make_train_step(cfg, TrainConfig(total_steps=total,
                                               warmup=1))
    ds = iter(lm_dataset(BATCH, SEQ, cfg.vocab_size, seed=args.seed))
    batches = [{k: to_device(v, dev) for k, v in next(ds).items()}
               for _ in range(total)]
    for b in batches[:args.warmup]:
        params, opt, _ = step_fn(params, opt, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches[args.warmup:]:
            t0 = time.perf_counter()
            with torch.profiler.record_function("train/step"):
                params, opt, metrics = step_fn(params, opt, b)
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        trace = json.load(f)
    res = analyse(trace, args.steps, prefix="train/", step="train/step")
    wall = float(np.mean(walls))
    busy = res["device_busy_ms_per_round"]
    ssd = kernel_ms(trace, "ssd_chunk", args.steps)
    res.update(arch=args.arch, wall_ms_per_step=wall, wall_ms_steps=walls,
               device_idle_share=1.0 - busy / wall,
               ssd_chunk_ms_per_step=ssd, loss=float(metrics["loss"]),
               device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print(f"{args.arch} steps={args.steps} wall={wall:.2f} ms/step "
          f"device_busy={busy:.2f} ms/step "
          f"idle_share={res['device_idle_share']:.3f} "
          f"launches={res['launches_per_round']:.0f}/step "
          f"sync_calls={res['sync_calls_per_round']}")
    for name, ph in res["phases"].items():
        print(f"  {name:<18} host {ph['host_ms']:8.3f} ms  device "
              f"{ph['device_ms']:8.3f} ms")
    print(f"  ssd_chunk {ssd:8.3f} ms/step")
    for name, ms in res["top_kernels_ms_per_round"].items():
        print(f"  kernel {ms:8.3f} ms  {name}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
