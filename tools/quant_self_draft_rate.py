"""granite-8b's quant self-draft acceptance rate (``chip_smoke.py`` phase
4q's sample: 2 prompts of 64 tokens, 48 new tokens, seed 0) with the
extension's flash kernels and with the flash wrapper replaced by its plain
version on the card, and the largest difference between the kernel and
the plain version over the flash calls of that run.

  python3 tools/quant_self_draft_rate.py

Needs one CUDA card.  The rate is the accepted draft tokens over blocks
times L; phase 4q holds it within 0.2 of the float32 run's (1.0).  Flash
only prefills the prompts, whose K/V the drafter and the target (the same
model here) share, so flash's rounding can move which sample is drawn but
not the drafter-target gap.  Nothing here is imported by the port.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)


def main() -> int:
    import torch

    import chip_smoke as C
    import repro_torch  # noqa: F401  (the float32 precision flags)
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.launch.serve import build_pair
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    target, _ = build_pair("granite-8b", 4, C.SEED, dev)
    kernel = ops.flash_attention
    worst = [0.0]

    def checked(*args, **kw):
        out = kernel(*args, **kw)
        ref = flash_attention_plain(*args, **kw)
        worst[0] = max(worst[0], float((out - ref).abs().max()))
        return out

    for name, fn in (("kernel", checked), ("plain", flash_attention_plain)):
        ops.flash_attention = fn
        acc = C.phase_self_draft(torch, dev, target, quant=True)
        print(f"{name}: quant self-draft rate {acc / C.L_DRAFT:.4f}",
              flush=True)
    ops.flash_attention = kernel
    print(f"kernel against plain over that run's flash calls: max abs err "
          f"{worst[0]:.3g}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
