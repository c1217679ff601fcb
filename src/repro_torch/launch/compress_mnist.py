"""beta-VAE distributed image compression on the synthetic MNIST-like
digits (paper Sec. 5 / Fig. 4) -- the port's twin of
``examples/compress_mnist.py`` and of ``benchmarks/bench_fig4_mnist.py``'s
grid: train the codec nets, then compress the right half of each test
image for K decoders holding 7x7 left-half crops, GLS against the
shared-randomness baseline.

  python -m repro_torch.launch.compress_mnist [--steps 600] \
      [--images 4000] [--trials 64] [--atoms 256] [--backend kernel] \
      [--device cpu]

Training: ``--steps`` Adam steps on ``--images`` digits (seed 0).
Testing: 400 digits (seed 1), K in {1, 2, 4}, l_max in {4, 32}, each
point ``--trials`` images in chunks of 64, one ``gls_binned_race``
launch per chunk with ``--backend kernel`` (``torch``: the sequenced
oracle, the same selections).  Runs on the card unless ``--device
cpu`` (rehearse with ``--device cpu --steps 20 --trials 8``).  Prints
the table and, last, one JSON line with every point.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch import random as R
from repro_torch.compression import VAETrainConfig, evaluate_rd, train_vae
from repro_torch.compression.pipeline import BACKENDS
from repro_torch.data.mnist import digits_dataset
from repro_torch.device import resolve_device

GRID_K = (1, 2, 4)
GRID_LMAX = (4, 32)
TEST_IMAGES = 400


def fig4_grid(params, test, *, trials: int, n_atoms: int, backend: str,
              device) -> list:
    """GLS and the shared-sheet baseline at every (K, l_max) of the grid,
    from ``PRNGKey(1)`` as JAX's benchmark: a list of dicts (k, l_max,
    gls, baseline, wall_s)."""
    rows = []
    for k in GRID_K:
        for l_max in GRID_LMAX:
            t0 = time.perf_counter()
            g, b = (evaluate_rd(R.PRNGKey(1), params, test, n_atoms=n_atoms,
                                l_max=l_max, k=k, trials=trials,
                                shared_sheet=shared, backend=backend,
                                device=device)
                    for shared in (False, True))
            rows.append({"k": k, "l_max": l_max, "gls": g, "baseline": b,
                         "wall_s": time.perf_counter() - t0})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--images", type=int, default=4000)
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--atoms", type=int, default=256)
    ap.add_argument("--backend", choices=BACKENDS, default="kernel",
                    help="race backend of the batched pipeline")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    imgs, _ = digits_dataset(args.images, seed=0)
    print(f"== training beta-VAE codec ({args.steps} steps, "
          f"{args.images} digits, {device}) ==")
    params = train_vae(R.PRNGKey(0), imgs,
                       VAETrainConfig(steps=args.steps, beta=0.35),
                       device=device)
    test, _ = digits_dataset(TEST_IMAGES, seed=1)
    rows = fig4_grid(params, test, trials=args.trials, n_atoms=args.atoms,
                     backend=args.backend, device=device)
    print(f"\npipeline backend: {args.backend}  atoms: {args.atoms}  "
          f"trials: {args.trials}")
    print("rate(bits)  K  GLS mse/match     baseline mse/match")
    for r in rows:
        g, b = r["gls"], r["baseline"]
        print(f"{g['rate_bits']:>9.0f} {r['k']:>3}  "
              f"{g['mse']:.4f}/{g['match_prob_any']:.2f}        "
              f"{b['mse']:.4f}/{b['match_prob_any']:.2f}")
    print(json.dumps({"fig4": rows}))
    return rows


if __name__ == "__main__":
    main()
