"""The batched request scheduler over the GLS speculative-decoding
engine, with its serving metrics -- the twin of
``examples/serve_scheduler.py``.

  python -m repro_torch.launch.serve_scheduler [--steps 100] \
      [--requests 6] [--max-new 24] [--max-batch 3] [--device cpu]

A target and a drafter (head dims 32 and 24) train through the port's
trainer; then one request trace is served through all three cache modes:
``reprefill`` (the reference engine re-scoring the whole prefix, one
block per request per round; JAX's "sequential"), ``kv`` (the KV-cached
slot pool, host-driven rounds) and ``kv_fused`` (the same pool, every
round one fused device program).  The outputs must be bit-identical
(the script exits non-zero otherwise); the sync counts are reported
(kv_fused: 0 draft syncs and one host sync a round).  The attention
kernels stay off, as in JAX's example.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import random as R
from repro_torch.data import encode, lm_dataset, synthetic_corpus
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params
from repro_torch.specdec import (
    CachedSpecDecEngine,
    SpecDecConfig,
    SpecDecEngine,
    SpecDecServer,
)
from repro_torch.train import TrainConfig, train

VOCAB = 128
TARGET = ModelConfig(name="sched-target", family="dense", num_layers=3,
                     d_model=192, num_heads=6, num_kv_heads=2, head_dim=32,
                     d_ff=384, vocab_size=VOCAB, dtype="float32")
DRAFTER = ModelConfig(name="sched-drafter", family="dense", num_layers=1,
                      d_model=96, num_heads=4, num_kv_heads=2, head_dim=24,
                      d_ff=192, vocab_size=VOCAB, dtype="float32")
MODES = ("reprefill", "kv", "kv_fused")
SPEC = SpecDecConfig(num_drafts=4, draft_len=3, strategy="gls", top_k=50)


def train_pair(steps: int, device, init=None, log=print) -> tuple:
    """(target params, drafter params, (target history, drafter
    history)): the target ``steps`` steps, the drafter half as many."""
    if init is None:   # the target from seed 0, the drafter from 1
        init = tuple(init_params(torch.Generator(device).manual_seed(s),
                                 cfg, device)
                     for cfg, s in ((TARGET, 0), (DRAFTER, 1)))
    tp, dp = init
    tc = TrainConfig(total_steps=steps, log_every=max(steps // 2, 1),
                     lr=1e-3)
    tp, t_hist = train(tp, TARGET, tc,
                       lm_dataset(16, 96, VOCAB, seed=0, num_sentences=4000),
                       device=device, log=log)
    dp, d_hist = train(dp, DRAFTER,
                       TrainConfig(total_steps=steps // 2, lr=1e-3,
                                   log_every=steps),
                       lm_dataset(16, 96, VOCAB, seed=1, num_sentences=4000),
                       device=device, log=log)
    return tp, dp, (t_hist, d_hist)


def serve(tp, dp, mode: str, requests: int, max_new: int, max_batch: int,
          device) -> tuple:
    """(server, completed requests) of the trace under ``mode``."""
    if mode in ("kv", "kv_fused"):
        eng = CachedSpecDecEngine((tp, TARGET), (dp, DRAFTER), SPEC,
                                  pool_slots=max_batch, device=device)
        server = SpecDecServer(eng, max_batch=max_batch, cache_mode=mode)
    else:
        eng = SpecDecEngine((tp, TARGET), [(dp, DRAFTER)], SPEC,
                            device=device)
        server = SpecDecServer(eng, max_batch=max_batch, batched=False,
                               cache_mode="reprefill")
    corpus = encode(synthetic_corpus(60, seed=11)) % VOCAB
    for i in range(requests):
        server.submit(corpus[i * 29:i * 29 + 12], max_new=max_new)
    return server, server.run(R.PRNGKey(7))


def main(argv=None, log=print) -> dict:
    """Prints each mode's requests and metrics; returns ``outputs`` (mode
    -> {uid: tokens}), ``metrics`` (mode -> ServerMetrics) and
    ``history``.  Raises SystemExit if a mode's outputs differ from
    reprefill's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    log("== training pair ==")
    tp, dp, history = train_pair(args.steps, device, log=log)

    outputs, metrics = {}, {}
    for mode in MODES:
        log(f"\n== serving {args.requests} requests "
            f"(max_batch={args.max_batch}, cache_mode={mode}) ==")
        server, done = serve(tp, dp, mode, args.requests, args.max_new,
                             args.max_batch, device)
        for r in done:
            lat = (r.t_done - r.t_submit)
            log(f"req {r.uid}: {len(r.output)} tokens, "
                f"BE={r.block_efficiency:.2f}, ttft={r.ttft_ms:.0f}ms, "
                f"latency={lat:.1f}s")
        m = server.metrics
        log(f"throughput: {m.tokens_per_s:.1f} tok/s  "
            f"mean BE: {m.mean_block_efficiency:.2f}  "
            f"completed: {m.completed}  rounds: {m.rounds}  "
            f"target-forwards: {m.target_forwards}")
        log(f"syncs/round: draft={m.draft_syncs / m.rounds:.1f}  "
            f"host={m.host_syncs / m.rounds:.1f}  "
            f"(totals: draft={m.draft_syncs} host={m.host_syncs} "
            f"over {m.rounds} rounds)")
        outputs[mode] = {r.uid: list(r.output) for r in done}
        metrics[mode] = m

    for mode in ("kv", "kv_fused"):
        match = outputs["reprefill"] == outputs[mode]
        log(f"\n{mode} output == reprefill output: {match}")
        if not match:
            raise SystemExit(f"scheduler paths diverged ({mode})!")
    return {"outputs": outputs, "metrics": metrics, "history": history}


if __name__ == "__main__":
    main()
