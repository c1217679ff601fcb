"""Train a target LM and a small drafter on the synthetic corpus, then
serve a batch of requests with drafter-invariant multi-draft speculative
decoding (the paper's Alg. 2) -- the twin of
``examples/serve_specdec.py``.

  python -m repro_torch.launch.serve_specdec [--steps 150] \
      [--requests 4] [--max-new 48] [--backend torch] [--device cpu]

Both models train through the port's trainer (the example's widths, head
dim 32) and serve through the reference engine (``SpecDecEngine``).  It
prints block efficiency across verification strategies, then across the
verifier backends: ``legacy`` (the per-token host loop), ``torch`` (the
fused block verifier; JAX's ``xla``) and ``kernel`` (the fused verifier
racing through the ``gls_row_race`` kernel on the card; JAX's
``pallas``).  The attention kernels stay off, as JAX's example leaves
``decode_kernel``/``prefill_kernel`` off.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.data import decode as detok
from repro_torch.data import encode, lm_dataset, synthetic_corpus
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params
from repro_torch.specdec import SpecDecConfig, SpecDecEngine
from repro_torch.train import TrainConfig, train

VOCAB = 128

TARGET = ModelConfig(name="serve-target", family="dense", num_layers=4,
                     d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
                     d_ff=512, vocab_size=VOCAB, dtype="float32")
DRAFTER = ModelConfig(name="serve-drafter", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                      d_ff=256, vocab_size=VOCAB, dtype="float32")
# The strategy table: (strategy, drafts).
TABLE = (("gls", 8), ("specinfer", 8), ("daliri", 1))
BACKEND_ORDER = ("legacy", "torch", "kernel")


def train_pair(steps: int, device, init=None, log=print) -> tuple:
    """(target params, drafter params, (target history, drafter
    history)) after ``steps`` steps each, from ``init`` (a (target,
    drafter) pair of parameter trees) or drawn from seeds 0 and 1."""
    if init is None:   # the target from seed 0, the drafter from 1
        init = tuple(init_params(torch.Generator(device).manual_seed(s),
                                 cfg, device)
                     for cfg, s in ((TARGET, 0), (DRAFTER, 1)))
    tparams, dparams = init
    tc = TrainConfig(total_steps=steps, log_every=max(steps // 3, 1),
                     lr=1e-3)
    tparams, t_hist = train(
        tparams, TARGET, tc,
        lm_dataset(16, 128, VOCAB, seed=0, num_sentences=6000),
        device=device, log=log)
    dparams, d_hist = train(
        dparams, DRAFTER, tc,
        lm_dataset(16, 128, VOCAB, seed=1, num_sentences=6000),
        device=device, log=log)
    return tparams, dparams, (t_hist, d_hist)


def make_prompts(requests: int) -> list:
    corpus = encode(synthetic_corpus(40, seed=9)) % VOCAB
    return [np.asarray(corpus[i * 53:i * 53 + 16], np.int32)
            for i in range(requests)]


def measure(tparams, dparams, strategy: str, k: int, backend: str,
            prompts: list, max_new: int, device) -> tuple:
    """(results, seconds, tokens/s, verify syncs) of one engine serving
    ``prompts`` on ``PRNGKey(7)``."""
    eng = SpecDecEngine(
        (tparams, TARGET), [(dparams, DRAFTER)],
        SpecDecConfig(num_drafts=k, draft_len=4, strategy=strategy,
                      top_k=50, max_new_tokens=max_new,
                      verifier_backend=backend), device=device)
    t0 = time.time()
    results = eng.serve(R.PRNGKey(7), prompts)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in results)
    return (results, dt, toks / max(dt, 1e-9),
            sum(r.host_syncs for r in results))


def main(argv=None, log=print) -> dict:
    """Prints the example's tables; returns ``table`` (strategy ->
    results under ``--backend``), ``backends`` (backend -> gls K = 8
    results) and ``history`` (the two training histories)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--backend", default="torch", choices=BACKEND_ORDER,
                    help="verifier backend for the strategy table")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    log("== training target + drafter on the synthetic corpus ==")
    tparams, dparams, history = train_pair(args.steps, device, log=log)
    prompts = make_prompts(args.requests)

    log(f"\n== serving batched requests (backend={args.backend}) ==")
    table = {}
    for strategy, k in TABLE:
        results, dt, tps, syncs = measure(tparams, dparams, strategy, k,
                                          args.backend, prompts,
                                          args.max_new, device)
        be = float(np.mean([r.block_efficiency for r in results]))
        log(f"{strategy:10s} K={k}  BE={be:.2f}  {tps:6.1f} tok/s  "
            f"verify-syncs={syncs}  ({dt:.1f}s for {len(prompts)} "
            f"requests)")
        if strategy == "gls":
            sample = detok(results[0].output)
            log(f"           sample output: {sample[:72]!r}")
        table[strategy] = results

    log("\n== verifier backends (gls, K=8): host-sync and tokens/s "
        "deltas ==")
    base_tps = None
    backends = {}
    for backend in BACKEND_ORDER:
        results, dt, tps, syncs = measure(tparams, dparams, "gls", 8,
                                          backend, prompts, args.max_new,
                                          device)
        base_tps = base_tps or tps
        log(f"{backend:8s} {tps:6.1f} tok/s ({tps / base_tps:4.2f}x)  "
            f"verify-syncs={syncs}")
        backends[backend] = results
    return {"table": table, "backends": backends, "history": history}


if __name__ == "__main__":
    main()
