"""Run some of ``chip_smoke.py``'s later phases alone, in a fresh process.

  python3 tools/chip_phases.py [--only train checkpoint examples vae \
      encdec_vlm]

Needs one CUDA card.  Builds the port's kernels from this checkout, then
runs the named phases (``phase_train``, ``phase_checkpoint`` on a
smollm-360m that ``train_full`` trains first as phase train does,
``phase_examples``, ``phase_vae``, ``phase_encdec_vlm``) with their
gates,
logging what ``chip_smoke.py`` logs for them, after no other phase: no
model was built and no profiler session ran before them in the process,
as they do inside the full script.  Prints the card's name and power
limit first and each phase's wall time after it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402



def _train(torch, dev, smi):
    return C.phase_train(torch, dev, smi)[:2]


def _checkpoint(torch, dev, smi):
    _, _, params = C.train_full(torch, dev, "smollm-360m", C.TRAIN_STEPS,
                                C.TRAIN_WARMUP, smi, keep=True)
    return C.phase_checkpoint(torch, dev, params, smi)


PHASES = {"train": _train, "checkpoint": _checkpoint,
          "examples": C.phase_examples, "vae": C.phase_vae,
          "encdec_vlm": C.phase_encdec_vlm}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(PHASES),
                    default=sorted(PHASES, reverse=True))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases needs a CUDA device")
    sys.path.insert(0, C.SRC)
    import repro_torch  # noqa: F401  (the float32 precision flags)
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    for name in args.only:
        t0 = time.perf_counter()
        print(PHASES[name](torch, dev, smi), flush=True)
        print(f"phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
