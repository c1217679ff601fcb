"""Offline data pipelines of the port: the synthetic text corpus and the
MNIST-like digits -- numpy copies of the JAX package's ``repro/data``,
bit-identical for the same seed."""

from repro_torch.data.mnist import digits_dataset, wz_split
from repro_torch.data.text import (
    BOS,
    EOS,
    PAD,
    VOCAB_SIZE,
    PackedDataset,
    decode,
    encode,
    lm_dataset,
    synthetic_corpus,
)

__all__ = [
    "BOS", "EOS", "PAD", "VOCAB_SIZE", "PackedDataset", "decode",
    "digits_dataset", "encode", "lm_dataset", "synthetic_corpus", "wz_split",
]
