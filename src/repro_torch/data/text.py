"""Offline text data pipeline -- the port's own copy of
``repro/data/text.py`` (numpy only; batches are bit-identical to the JAX
package's for the same seed): a deterministic synthetic corpus (no
downloads), a byte-level tokenizer, and a packed batching iterator.

The synthetic corpus is structured English-like text with heavy n-gram
regularities so that (a) a ~100M target model trained for a few hundred
steps becomes meaningfully predictable and (b) a small drafter aligns
with it — the regime where speculative decoding pays off, mirroring the
paper's GSM8K/HumanEval-style evaluation at laptop scale.
"""

from __future__ import annotations

import numpy as np

VOCAB_SIZE = 256 + 3  # bytes + BOS/EOS/PAD
BOS, EOS, PAD = 256, 257, 258

_SUBJECTS = ["the engineer", "a student", "the model", "our system",
             "the decoder", "the encoder", "a reviewer", "the compiler"]
_VERBS = ["computes", "samples", "accepts", "rejects", "verifies",
          "couples", "compresses", "matches", "proposes", "decodes"]
_OBJECTS = ["the token", "a draft", "the sequence", "a distribution",
            "the message", "the index", "the residual", "an estimate"]
_MODS = ["quickly", "exactly", "with high probability", "in parallel",
         "without communication", "at a lower rate", "per step",
         "using shared randomness"]
_MATH = ["1 + 2 = 3", "2 * 3 = 6", "7 - 4 = 3", "9 / 3 = 3", "5 + 5 = 10",
         "8 - 6 = 2", "4 * 4 = 16", "6 + 7 = 13"]


def synthetic_corpus(num_sentences: int = 20_000, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(num_sentences):
        if rng.random() < 0.2:
            parts.append(f"we check that {rng.choice(_MATH)} .")
        else:
            parts.append(
                f"{rng.choice(_SUBJECTS)} {rng.choice(_VERBS)} "
                f"{rng.choice(_OBJECTS)} {rng.choice(_MODS)} .")
    return " ".join(parts)


def encode(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)


def decode(tokens) -> str:
    toks = [t for t in np.asarray(tokens).tolist() if t < 256]
    return bytes(toks).decode("utf-8", errors="replace")


class PackedDataset:
    """Pack a token stream into (batch, seq) blocks; targets are inputs
    shifted by one (standard LM objective)."""

    def __init__(self, tokens: np.ndarray, batch: int, seq: int,
                 seed: int = 0):
        self.tokens = tokens
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed)
        self.n_blocks = (len(tokens) - 1) // seq

    def __iter__(self):
        return self

    def __next__(self):
        starts = self.rng.integers(0, len(self.tokens) - self.seq - 1,
                                   self.batch)
        x = np.stack([self.tokens[s:s + self.seq] for s in starts])
        y = np.stack([self.tokens[s + 1:s + self.seq + 1] for s in starts])
        return {"tokens": x, "targets": y}


def lm_dataset(batch: int, seq: int, vocab_size: int, seed: int = 0,
               num_sentences: int = 20_000) -> PackedDataset:
    """Corpus tokenized and folded into ``vocab_size`` (byte ids are
    taken mod vocab when models use a smaller vocabulary)."""
    toks = encode(synthetic_corpus(num_sentences, seed))
    if vocab_size < VOCAB_SIZE:
        toks = toks % vocab_size
    return PackedDataset(toks, batch, seq, seed)
