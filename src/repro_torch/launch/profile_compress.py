"""Where a chunk of the Wyner-Ziv compression path spends its time on the
card.

  python -m repro_torch.launch.profile_compress [--chunks 3] \
      [--trace build/profile_compress_trace.json]

Runs the full-size configuration of ``chip_smoke.py``'s compress phase
(Gaussian source, sigma2_w|a 0.005, B = 512 trials per chunk, N = 2^16
atoms, K = 4 decoders, l_max = 64, backend "kernel", keys from seed
0), warms up one chunk, then runs ``--chunks`` chunks under
``torch.profiler`` (CPU and CUDA activities), each ending in its host
fetch.  It prints, per chunk:
wall time, device busy time and idle share, kernel launches, the host's
synchronising calls, the host and device time of each
``compress/<phase>`` range (setup: keys, samplers, weights, bins; race:
sheets and the one ``gls_binned_race`` launch; reconstruct), and the
top kernels by device time.  The last line is a JSON object with the
same numbers.  Needs the card.
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
from repro_torch.compression import gaussian as G
from repro_torch.launch.profile_round import analyse

SIGMA2, BATCH, ATOMS, DECODERS, L_MAX = 0.005, 512, 2 ** 16, 4, 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--trace", default=os.path.join(
        "build", "profile_compress_trace.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_compress needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = G.GaussianWZ(sigma2_w_given_a=SIGMA2, n_atoms=ATOMS)
    keys = R.split(R.PRNGKey(0).to(dev), (args.chunks + 1) * BATCH)

    def chunk(i):
        out = G._batch_trials(keys[i * BATCH:(i + 1) * BATCH], cfg,
                              DECODERS, L_MAX, False, "kernel")
        return [t.cpu() for t in out]

    chunk(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(1, args.chunks + 1):
            t0 = time.perf_counter()
            with torch.profiler.record_function("compress/chunk"):
                chunk(i)
            walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        res = {k.replace("_round", "_chunk"): v for k, v in
               analyse(json.load(f), args.chunks, prefix="compress/",
                       step="compress/chunk").items()}
    wall = float(np.mean(walls))
    res.update(wall_ms_per_chunk=wall, wall_ms_chunks=walls,
               trials_per_s=BATCH / wall * 1e3,
               device_idle_share=1.0 - res["device_busy_ms_per_chunk"] / wall,
               device=torch.cuda.get_device_name(0))
    print(f"chunks={args.chunks} of {BATCH} trials: wall={wall:.2f} "
          f"ms/chunk ({res['trials_per_s']:.1f} trials/s) device_busy="
          f"{res['device_busy_ms_per_chunk']:.2f} ms/chunk idle_share="
          f"{res['device_idle_share']:.3f} "
          f"launches={res['launches_per_chunk']:.0f}/chunk "
          f"sync_calls={res['sync_calls_per_chunk']}")
    for name, ph in res["phases"].items():
        print(f"  {name:<22} host {ph['host_ms']:8.3f} ms  device "
              f"{ph['device_ms']:8.3f} ms")
    for name, ms in res["top_kernels_ms_per_chunk"].items():
        print(f"  kernel {ms:8.3f} ms  {name}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
