"""Time the port's small kernels of one or more source trees the way
``chip_smoke.py`` times them.

  python3 tools/time_small_kernels.py [--serve | --giants] [SRC ...]

Needs one CUDA card.  Each ``SRC`` is a tree's ``src`` directory (default:
this repository's ``src``; a parent commit unpacked with ``git archive``
works the same), run in its own process in the order given, so ``A B B A``
shows the drift between turns.  Each process builds that tree's kernels
(its own ``build/``) and times them through the tree's own wrappers with
``chip_smoke.py``'s functions: ``decode_attention`` and its int8 instance
at smollm-360m's serve shape (q (32, 15, 64), (32, 5, 370, 64) K/V) and
granite-8b's (q (32, 32, 128), (32, 8, 370, 128)), each cycling through
K/V sets worth more than the L2 cache with the serve's kv_len; the row
race at the kv_fused verifier's (20, 8, 49152) and the reprefill
verifier's (5, 8, 50280), cycling through three L2 caches of tables; the
joint race ``gls_race`` at (20, 8, 49152) (``chip_smoke.joint_inputs``,
94 MB a call); the four instances of ``flash_attention`` (float32 and
int8 K/V at head dims 64 and 128) at the admission shapes of smollm-360m
(q (32, 15, 256, 64), K/V (32, 5, 370, 64)) and granite-8b (q (32, 32,
256, 128), K/V (32, 8, 370, 128)), ``chip_smoke.flash_inputs``, whose q
and K/V are read cold at 128.  Per tree and kernel it prints the
CUDA-event time (``ms``), the kernel's device time per launch from
``torch.profiler`` (``device_ms``), the plain version's time and the
library call's (SDPA for attention; ``torch.min`` on a precomputed
score, a note, for the races), and the bound (flash: the tensor-core
bound, with the float32-FMA bound beside it); with ``--serve``, instead
of the kernels, ``chip_smoke.py``'s phase 3q serve of smollm-360m (int8
arenas, W8A8 verify): tok/s, round wall and mean TTFT; with ``--giants``,
instead, the decode at the dense giants' groups, float32 and int8:
granite-34b's q (32, 48, 128) over K/V (32, 1, T, 128) and llama3-405b's
q (32, 128, 128) over (32, 8, T, 128), at T = 86 with the serve's kv_len
(``chip_smoke.decode_inputs``) and at T = 4,096 with every key live,
each on K/V sets worth three L2 caches.  Then the card's name and power
limit.  Nothing here is imported by the port.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (b, h, hkv, d, t): smollm-360m's and granite-8b's decode serve shapes.
DECODES = ((32, 15, 5, 64, 370), (32, 32, 8, 128, 370))
RACES = ((20, 49152), (5, 50280))      # (rows of K drafts, vocab)
# (b, h, hkv, d, s, t): the two admission shapes of flash_attention.
FLASHES = ((32, 15, 5, 64, 256, 370), (32, 32, 8, 128, 256, 370))
JOINT_VOCAB = 49152
# (b, h, hkv, d): the giants' decode shapes, at these T (the serve's
# buffer, then every key live over 4,096).
GIANT_DECODES = ((32, 48, 1, 128), (32, 128, 8, 128))
GIANT_TS = (86, 4096)


def giant_decodes(torch, dev) -> dict:
    """The float32 and int8 decode at the giants' groups and ``GIANT_TS``,
    through the tree's own wrappers."""
    import chip_smoke as C
    res = {}
    for b, h, hkv, d in GIANT_DECODES:
        for t in GIANT_TS:
            full = t != GIANT_TS[0]
            tag = f"_g{h // hkv} T={t}"
            q, kv_sets, kv_len = C.decode_inputs(
                torch, dev, b, h, hkv, d, t, C.cold_sets(8 * b * hkv * t * d),
                full=full)
            t_bound, _, t_fma = C.decode_bound(b, h, hkv, d,
                                               float(kv_len.sum()))
            res[f"decode_attention_d{d}{tag}"] = {
                **C.time_decode(torch, q, kv_sets, kv_len),
                "bound_ms": t_bound, "bound_fma_ms": t_fma}
            del q, kv_sets
            q, sets, (kf, vf), kv_len = C.decode_int8_inputs(
                torch, dev, b, h, hkv, d, t, full=full)
            t_bound, _, t_fma = C.decode_bound(b, h, hkv, d,
                                               float(kv_len.sum()), int8=True)
            res[f"decode_attention_int8_d{d}{tag}"] = {
                **C.time_decode_int8(torch, q, sets, kv_len, kf, vf),
                "bound_ms": t_bound, "bound_fma_ms": t_fma}
            del q, sets, kf, vf
            C.gc_collect(torch)
    return res


def one_tree(src: str, serve: bool = False, giants: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(1, os.fspath(ROOT))
    import torch

    import chip_smoke as C
    from repro_torch.kernels import build
    build.load_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    res = {}
    if serve:
        from repro_torch.launch.serve import build_pair
        target, drafter = build_pair("smollm-360m", 4, C.SEED, dev)
        _, stats = C.phase_serve(torch, dev, target, drafter, quant=True)
        return {"serve quant": stats}
    if giants:
        return giant_decodes(torch, dev)
    for b, h, hkv, d, t in DECODES:
        suffix = "" if d == 64 else f"_d{d}"
        q, kv_sets, kv_len = C.decode_inputs(torch, dev, b, h, hkv, d, t)
        keys = float(kv_len.sum())
        res["decode_attention" + suffix] = {
            **C.time_decode(torch, q, kv_sets, kv_len),
            "bound_ms": C.decode_bound(b, h, hkv, d, keys)[0]}
        del q, kv_sets
        q, sets, (kf, vf), kv_len = C.decode_int8_inputs(torch, dev, b, h,
                                                         hkv, d, t)
        res["decode_attention_int8" + suffix] = {
            **C.time_decode_int8(torch, q, sets, kv_len, kf, vf),
            "bound_ms": C.decode_bound(b, h, hkv, d, float(kv_len.sum()),
                                       int8=True)[0]}
        del q, sets, kf, vf
    for rows, vocab in RACES:
        nbytes = 2 * rows * C.K_DRAFTS * vocab * 4
        sets = C.race_inputs(torch, dev, rows, vocab, C.cold_sets(nbytes),
                             C.SEED)
        res[f"gls_row_race ({rows}, {C.K_DRAFTS}, {vocab})"] = {
            **C.time_race(torch, sets),
            "bound_ms": C.bound(nbytes + rows * C.K_DRAFTS * 8,
                                3 * rows * C.K_DRAFTS * vocab)[0]}
        del sets
    args = C.joint_inputs(torch, dev, JOINT_VOCAB)
    res[f"gls_race {tuple(args[0].shape)}"] = {
        **C.time_joint(torch, args), "bound_ms": C.joint_bound(args)[0]}
    del args
    from repro_torch.kernels.flash_attention.ops import flash_attention
    for b, h, hkv, d, s, t in FLASHES:
        for int8 in (False, True):
            name = ("flash_attention" + ("_int8" if int8 else "")
                    + ("" if d == 64 else f"_d{d}"))
            args, mask = C.flash_inputs(torch, dev, b, h, hkv, d, s, t, int8)
            t_bound, _, t_fma = C.flash_bound(h, hkv, d, mask, args[4], t,
                                              int8)
            res[name] = {**C.time_flash(torch, args, mask),
                         "device_ms": C.device_ms(
                             torch, [lambda: flash_attention(*args)],
                             "flash_attention"),
                         "bound_ms": t_bound, "bound_fma_ms": t_fma}
            del args, mask
    return res


def main(argv) -> int:
    flags = [a for a in argv if a in ("--serve", "--giants")]
    argv = [a for a in argv if a not in flags]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one_tree(argv[1], "--serve" in flags,
                                  "--giants" in flags)))
        return 0
    trees = argv or [os.fspath(ROOT / "src")]
    rows = []
    for src in trees:
        r = subprocess.run([sys.executable, __file__, "--one", src] + flags,
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(f"{src}: failed\n{r.stdout}{r.stderr}", file=sys.stderr)
            return 1
        rows.append((src, json.loads(r.stdout.strip().splitlines()[-1])))
    for src, res in rows:
        for name, m in res.items():
            if name == "serve quant":
                print(f"{src}: smollm-360m {name}: " + ", ".join(
                    f"{k} {m[k]:.4f}" for k in ("tok_s", "round_ms",
                                                 "ttft_ms")), flush=True)
                continue
            lib = m.get("library_ms", m.get("note_ms"))
            fma = (f", float32-FMA bound {m['bound_fma_ms']:.4f}"
                   if "bound_fma_ms" in m else "")
            print(f"{src}: {name}: ms {m['ms']:.4f}, device_ms "
                  f"{m['device_ms']:.4f}, plain "
                  f"{m['plain_ms']:.4f}, library/note {lib:.4f}, bound "
                  f"{m['bound_ms']:.4f}{fma}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
