"""Does a finished ``torch.profiler`` session slow the launches after it?

  python3 tools/launch_overhead.py [--steps 8] [--launches 20000]

Needs one CUDA card.  Trains smollm-360m at its published widths
(``chip_smoke.py`` phase train's workload: batch 8 x seq 128 from
``lm_dataset``, ``make_train_step``, float32, remat) and times, before
and after one short ``torch.profiler`` session (CPU and CUDA
activities) in the same process: the host's cost of one launch (the
mean over ``--launches`` in-place adds to a 16-element tensor, three
samples) and the median wall of ``--steps`` train steps, each ended by a
synchronise.  ``chip_smoke.py`` runs its training phase after several
profiler sessions; ``tools/chip_phases.py`` runs it after none.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--launches", type=int, default=20000)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("launch_overhead needs a CUDA device")
    import repro_torch  # noqa: F401  (the float32 precision flags)
    from repro_torch.configs import get_config
    from repro_torch.data import lm_dataset
    from repro_torch.device import to_device
    from repro_torch.models import init_params
    from repro_torch.optim import adam_init
    from repro_torch.train import TrainConfig, make_train_step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = {"params": init_params(gen, cfg, dev)}
    state["opt"] = adam_init(state["params"])
    step = make_train_step(cfg, TrainConfig(total_steps=4 * args.steps,
                                            warmup=5))
    ds = iter(lm_dataset(8, 128, cfg.vocab_size))
    x = torch.zeros(16, device=dev)

    def launch_us() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.launches):
            x.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.launches * 1e6

    def step_ms(n: int) -> list:
        out = []
        for _ in range(n):
            b = {k: to_device(v, dev) for k, v in next(ds).items()}
            t0 = time.perf_counter()
            state["params"], state["opt"], _ = step(state["params"],
                                                    state["opt"], b)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    step_ms(2)                               # warm-up
    for label in ("before", "after"):
        if label == "after":
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                for _ in range(10):
                    x.add_(1.0)
                torch.cuda.synchronize()
        us = [launch_us() for _ in range(3)]
        ms = step_ms(args.steps)
        print(f"{label} a profiler session: one launch "
              + ", ".join(f"{u:.2f}" for u in us)
              + f" us; smollm-360m train step ms median "
              f"{statistics.median(ms):.2f} (min {min(ms):.2f}, max "
              f"{max(ms):.2f})", flush=True)


if __name__ == "__main__":
    main()
