"""Wyner-Ziv compression of a Gaussian source with K decoders (paper
Sec. 5 / Fig. 2): GLS against the shared-randomness baseline across
rates -- the port's counterpart of ``examples/compress_gaussian.py``.

  python -m repro_torch.launch.compress [--trials 1500] [--atoms 4096] \
      [--backend kernel] [--seed 0] [--device cpu]

Trials stream through the batched pipeline (``compression/pipeline.py``):
one ``gls_binned_race`` launch per chunk of trials with ``--backend
kernel``, the plain sequenced oracle with ``--backend torch`` (the same
selections either way).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from repro_torch import random as R
from repro_torch.compression import GaussianWZ, run_experiment
from repro_torch.compression.pipeline import BACKENDS
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=1500)
    ap.add_argument("--atoms", type=int, default=4096,
                    help="importance atoms N per trial")
    ap.add_argument("--backend", choices=BACKENDS, default="kernel",
                    help="race backend of the batched pipeline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = GaussianWZ(sigma2_w_given_a=0.005, n_atoms=args.atoms)
    key = R.PRNGKey(args.seed)
    print(f"pipeline backend: {args.backend}  device: {device}  "
          f"atoms: {args.atoms}  trials: {args.trials}")
    print("rate(bits)  K  GLS match / D(dB)      baseline match / D(dB)"
          "   match bound")
    for l_max in (2, 8, 32):
        for k in (1, 2, 4):
            g = run_experiment(key, cfg, k, l_max, args.trials,
                               backend=args.backend, device=device)
            b = run_experiment(key, cfg, k, l_max, args.trials,
                               shared_sheet=True, backend=args.backend,
                               device=device)
            print(f"{g['rate_bits']:>9.0f} {k:>3}  "
                  f"{g['match_prob_any']:.3f} / {g['distortion_db']:7.2f}    "
                  f"{b['match_prob_any']:.3f} / {b['distortion_db']:7.2f}"
                  f"    >={g['match_lower_bound']:.3f}")
    print("\nGLS == baseline at K=1; GLS wins for K>1, most at low rates.")
    print("'match bound' is the Prop.-4 lower bound on the GLS "
          "any-decoder match rate.")


if __name__ == "__main__":
    main()
