"""Train a language model of the port on the synthetic corpus -- the
twin of ``repro/launch/train.py`` and ``examples/train_lm.py``.

  python -m repro_torch.launch.train --arch smollm-360m --steps 50 \
      [--batch 8] [--seq 128] [--reduced] [--seed 0] [--device cpu] \
      [--checkpoint PATH]

Published widths by default (``--reduced``: the family's smoke variant,
the CPU rehearsal: ``--reduced --device cpu --steps 2``).  Weights are
random from ``--seed``; batches come from ``data.lm_dataset``.  Runs on
the card unless ``--device cpu``, on one device (no mesh: ROADMAP item
17), and prints the loss every ``log_every`` steps.  ``--checkpoint PATH``
saves ``{"params": ...}`` at the end in JAX's layout and byte format
(``repro/launch/train.py:67-69``), a file JAX's ``load_checkpoint``
reads.  Decoder-only
families only, as JAX's launcher (``repro/launch/train.py:45-46``):
whisper-small and llama-3.2-vision-11b are refused (their batches need
frames or images, which ``lm_dataset`` does not make); the trainer
itself takes them (``train.make_train_step``).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import lm_dataset
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig, train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("text-LM launcher: decoder-only archs")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(gen, cfg, device)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n:,} params, device={device}")
    tcfg = TrainConfig(total_steps=args.steps,
                       log_every=max(args.steps // 10, 1))
    ds = lm_dataset(args.batch, args.seq, cfg.vocab_size, seed=args.seed)
    _, history = train(params, cfg, tcfg, ds, device=device,
                       checkpoint_path=args.checkpoint)
    print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
