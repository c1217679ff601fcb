"""The quant self-draft acceptance rate that ``chip_smoke.py`` phases 4q
and granite 4q hold (the served quant path against float32's rate, 1.0),
over independent samples, with each flash route.

  python3 tools/quant_self_draft_rate.py [--arch smollm-360m granite-8b]
      [--samples 12] [--routes kernel plain] [--decompose] [--trace]
      [--parent DIR]

A sample is one unit of the gate (``chip_smoke.self_draft_unit``: 4
prompts of 64 tokens, 48 new tokens each, its own prompts and round
key); sample i is the gate's unit i.  For each model and route the tool
prints the per-sample rates (accepted / (blocks L)), their mean and
standard deviation, the standard error of the gate's statistic (the mean
over ``chip_smoke.self_draft_units(arch)`` units) and the rate of the old
2-prompt sample (unit 0's requests 1 and 2).  Routes: ``kernel`` (the
extension's flash kernels, each call also held against the plain
version: the largest difference is printed) and ``plain`` (the flash
wrapper replaced by its plain version on the card).

Each route runs the served quant path ("quant": int8 arenas and the
W8A8 verify, ``chip_smoke.self_draft_engine``).  ``--decompose`` splits
it, in this process's patched engines (nothing in the port changes):
on each route the int8 arenas with the float32 verify tree, then on the
kernel route float32 arenas with the W8A8 verify tree, and the float32
self-draft.
``--trace`` serves the old 2-prompt sample with both routes and prints
where they part: the prefill's int8 K/V entries that
differ and how far each lay from a rounding boundary of ``quantize_kv``,
then the first race (draft step or verify) whose pick differs in a live
slot, with the top race scores of both routes there (a near-tie: the gap
between the two best within the drift of the best score between the
routes over the rows of that race whose picks agree).
``--parent DIR`` first runs the kernel route with the sources of an
unpacked parent tree (``DIR/src``, built into ``DIR/build``) in a
subprocess.

Needs one CUDA card.  Nothing here is imported by the port.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _top3(score):
    """(values, indices) of the three least race scores of each row."""
    import torch
    v, i = torch.topk(score.reshape(-1, score.shape[-1]), 3, dim=-1,
                      largest=False)
    return v.cpu(), i.cpu()


class Recorder:
    """Hooks on the round's races and on ``quantize_kv`` for ``--trace``:
    every race's picks and three best scores with the slots live at that
    round, and the int8 values and distances from a rounding boundary
    (|frac(x / scale) - 0.5|) of every quantization before the first
    race (the admission prefill)."""

    def __init__(self):
        self.races, self.quant, self.live, self.admitted = [], [], [], []

    def install(self, engine):
        import torch
        from repro_torch.serving import quant as Q
        from repro_torch.specdec import block_verify as BV
        from repro_torch.specdec import verify as V
        saved = [(V, "gumbel_race_argmin", V.gumbel_race_argmin),
                 (BV, "gls_row_race", BV.gls_row_race),
                 (Q, "quantize_kv", Q.quantize_kv),
                 (engine, "round_with_admission",
                  engine.round_with_admission),
                 (engine, "admit_batch", engine.admit_batch)]
        rec = self
        race0, row0, quant0, round0, admit0 = (x[2] for x in saved)

        def draft_race(log_u, probs):
            out = race0(log_u, probs)
            rec.races.append(("draft", list(rec.live), out.cpu(),
                              *_top3(V.race_scores(log_u, probs))))
            return out

        def verify_race(log_s, log_q):
            rmin, rarg = row0(log_s, log_q)
            score = torch.where(torch.isfinite(log_q), log_s - log_q,
                                torch.full_like(log_s, float("inf")))
            rec.races.append(("verify", list(rec.live), rarg.cpu(),
                              *_top3(score)))
            return rmin, rarg

        def quantize(x):
            q, scale = quant0(x)
            if not rec.races:
                y = x.float() / scale
                rec.quant.append((q.clone(),
                                  ((y - torch.floor(y)) - 0.5).abs()))
            return q, scale

        def round_with_admission(subs, uids, *a, **kw):
            rec.live = [engine._sessions[u].slot for u in uids]
            return round0(subs, uids, *a, **kw)

        def admit_batch(pairs, *a, **kw):
            out = admit0(pairs, *a, **kw)
            rec.admitted = [engine._sessions[u].slot for u, _ in pairs]
            return out

        V.gumbel_race_argmin = draft_race
        BV.gls_row_race = verify_race
        Q.quantize_kv = quantize
        engine.round_with_admission = round_with_admission
        engine.admit_batch = admit_batch
        return saved

    @staticmethod
    def remove(saved):
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def trace(C, torch, dev, target, engine, routes):
    """Serve the old 2-prompt sample (two prompts, two slots, key SEED +
    1) with the kernel and plain flash routes and print where they part."""
    from repro_torch import random as R
    from repro_torch.specdec import SpecDecServer
    vocab = target[1].vocab_size
    recs, outs = {}, {}
    for name, fn in routes.items():
        set_route(fn)
        rec = Recorder()
        saved = rec.install(engine)
        try:
            server = SpecDecServer(engine, max_batch=2)
            for p in C.self_draft_unit(vocab, 0)[0][:2]:
                server.submit(p, max_new=C.SELF_DRAFT_NEW)
            done = server.run(R.PRNGKey(C.SEED + 1))
        finally:
            Recorder.remove(saved)
        acc = sum(r.accepted for r in done)
        blocks = sum(r.blocks for r in done)
        print(f"trace, {name} route: old 2-prompt sample rate "
              f"{acc / (blocks * C.L_DRAFT):.4f} ({acc} accepted, {blocks} "
              f"blocks)", flush=True)
        recs[name] = rec
        outs[name] = {r.uid: list(r.output) for r in done}
    a, b = (recs[n] for n in ("kernel", "plain"))
    K = C.K_DRAFTS
    # The admitted slots' arena rows (slot s holds rows s K .. s K + K - 1);
    # the other rows of a prefill dispatch are write-masked and unused.
    rows = [sl * K + k for sl in a.admitted for k in range(K)]
    shares, first = [], None
    for i, ((qa, da), (qb, db)) in enumerate(zip(a.quant, b.quant)):
        qa, qb, da, db = qa[rows], qb[rows], da[rows], db[rows]
        diff = qa != qb
        shares.append(float(diff.float().mean()))
        if first is None and bool(diff.any()):
            steps = (qa[diff].long() - qb[diff].long()).abs()
            first = (i, int(diff.sum()), diff.numel(), int(steps.max()),
                     float(da[diff].max()), float(db[diff].max()))
    print(f"trace: prefill int8 K/V of the admitted rows, "
          f"{len(a.quant)} quantize_kv calls (K then V per layer, target "
          f"then drafter): " + ("the same in both routes" if first is None
                               else
          f"the first call that differs is {first[0]}: {first[1]} of "
          f"{first[2]} entries, by at most {first[3]} quantum, each within "
          f"{max(first[4], first[5]):.3g} of a rounding boundary "
          f"(|frac(x / scale) - 0.5|); share of entries that differ, every "
          f"8th call: {[round(x, 4) for x in shares[::8]]}"), flush=True)
    for uid in sorted(outs["kernel"]):
        ta, tb = outs["kernel"][uid], outs["plain"][uid]
        first = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     None)
        print(f"trace: request {uid}: "
              + ("same tokens" if first is None else
                 f"first differing output token {first} (kernel {ta[first]}, "
                 f"plain {tb[first]})"), flush=True)
    L = C.L_DRAFT
    per_round = L + 1
    for i, (ra, rb) in enumerate(zip(a.races, b.races)):
        kind, live, pick_a, va, ia = ra
        _, _, pick_b, vb, ib = rb
        pa, pb = pick_a.reshape(-1), pick_b.reshape(-1)
        if kind == "draft":
            rows = [s * K + k for s in live for k in range(K)]
        else:
            rows = [(s * (L + 1) + j) * K + k for s in live
                    for j in range(L + 1) for k in range(K)]
        bad = [r for r in rows if pa[r] != pb[r]]
        if not bad:
            continue
        r = bad[0]
        gaps = (va[rows, 1] - va[rows, 0])
        gaps = gaps[torch.isfinite(gaps)]
        step = (i % per_round if kind == "draft"
                else f"verify, draft step {(r // K) % (L + 1)}")
        print(f"trace: first race that parts: round {i // per_round + 1}, "
              f"{kind} race (step {step}), row {r} of slot "
              f"{r // (K * (1 if kind == 'draft' else L + 1))}: kernel "
              f"route picks {int(pa[r])}, plain {int(pb[r])}", flush=True)
        for name, v, idx in (("kernel", va, ia), ("plain", vb, ib)):
            print(f"trace:   {name} route's three best (token: score): "
                  + ", ".join(f"{int(t)}: {float(s):.9g}"
                              for t, s in zip(idx[r], v[r])), flush=True)
        ta, tb = ia[r].tolist(), ib[r].tolist()
        moved = max((abs(float(va[r, ta.index(x)] - vb[r, tb.index(x)]))
                     for x in set(ta) & set(tb)), default=float("nan"))
        agree = [x for x in rows if pa[x] == pb[x]]
        drift = (va[agree, 0] - vb[agree, 0]).abs() if agree else None
        gap = float(va[r, 1] - va[r, 0])
        print(f"trace:   gap of the two best {gap:.3g} (kernel route), "
              f"{float(vb[r, 1] - vb[r, 0]):.3g} (plain); the best score's "
              f"drift between the routes over the {len(agree)} live rows "
              f"of that race that agree: median "
              f"{float(drift.median()):.3g}, largest "
              f"{float(drift.max()):.3g}; median gap of the two best "
              f"{float(gaps.median()):.3g}: "
              + ("a near-tie (the gap within the drift the agreeing rows "
                 "show)" if gap <= float(drift.max()) else
                 f"not a near-tie: the gap exceeds the drift of every "
                 f"agreeing row; this row's scores moved by up to "
                 f"{moved:.3g} among the shared candidates"), flush=True)
        break
    else:
        print("trace: no race parts between the routes", flush=True)


def set_route(fn):
    from repro_torch.kernels.flash_attention import ops
    ops.flash_attention = fn


def report(C, arch, label, per_unit, old):
    rates, mean, sd, se = C.rate_stats(per_unit)
    m = C.self_draft_units(arch)
    print(f"{label}: {len(rates)} samples, rates "
          f"{[round(r, 4) for r in rates]}, mean {mean:.4f} sd {sd:.4f}, "
          f"se of the mean over {len(rates)} samples {se:.4f}, over the "
          f"gate's {m} units {sd / m ** 0.5:.4f}; the old 2-prompt sample "
          f"{old[0] / (old[1] * C.L_DRAFT):.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["smollm-360m", "granite-8b"])
    ap.add_argument("--samples", type=int, default=12)
    ap.add_argument("--routes", nargs="+", default=["kernel", "plain"],
                    choices=["kernel", "plain"])
    ap.add_argument("--decompose", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the port's sources to import (default: this "
                         "tree's)")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)

    import gc

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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    kernel = ops.flash_attention
    worst = [0.0]

    def checked(*a, **kw):
        out = kernel(*a, **kw)
        ref = flash_attention_plain(*a, **kw)
        worst[0] = max(worst[0], float((out - ref).abs().max()))
        return out

    routes = {"kernel": checked, "plain": flash_attention_plain}
    prefix = f"{args.label} " if args.label else ""
    if args.parent:
        # First, while this process holds nothing on the card.
        cmd = [sys.executable, os.path.abspath(__file__), "--src",
               os.path.join(args.parent, "src"), "--label", "parent",
               "--samples", str(args.samples), "--routes", "kernel",
               "--arch", *args.arch]
        print(f"running: {' '.join(cmd)}", flush=True)
        if subprocess.run(cmd, cwd=ROOT, check=False).returncode:
            return 1
    for arch in args.arch:
        target, _ = build_pair(arch, 4, C.SEED, dev)
        engine = C.self_draft_engine(torch, dev, target, "quant")
        kinds = [("quant", engine)]
        if args.decompose:
            arenas = C.self_draft_engine(torch, dev, target, "quant")
            arenas._t_verify_params = arenas.t_params
            kinds.append(("int8 arenas, float32 verify", arenas))
        for route in args.routes:
            set_route(routes[route])
            for kind, eng in kinds:
                worst[0] = 0.0
                per_unit, old = C.self_draft_rates(
                    torch, dev, target, kind, args.samples, engine=eng)
                report(C, arch, f"{prefix}{arch} {kind}, flash {route}",
                       per_unit, old)
                if route == "kernel":
                    print(f"{prefix}{arch} {kind}: kernel against plain "
                          f"over that run's flash calls: max abs err "
                          f"{worst[0]:.3g}", flush=True)
        set_route(kernel)
        del kinds
        if args.decompose:
            del arenas
            verify = C.self_draft_engine(torch, dev, target, "float32")
            verify._t_verify_params = engine._t_verify_params
            f32 = C.self_draft_engine(torch, dev, target, "float32")
            for name, eng in (("float32 arenas, W8A8 verify", verify),
                              ("float32", f32)):
                report(C, arch, f"{prefix}{arch} {name}, flash kernel",
                       *C.self_draft_rates(torch, dev, target, name,
                                           args.samples, engine=eng))
            del verify, f32
        if args.trace:
            trace(C, torch, dev, target, engine, routes)
            set_route(kernel)
        del target, engine
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
