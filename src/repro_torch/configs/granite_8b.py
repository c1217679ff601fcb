"""granite-8b [dense] at its published widths -- the port's own copy of
the JAX package's ``configs/granite_8b.py``: a llama-arch code model,
GQA with 4 query heads per KV head at head dim 128.  Served in float32,
the precision every serving test of the repository runs in.
[arXiv:2405.04324]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,           # GQA: 4 query heads per KV head
    head_dim=128,
    d_ff=14_336,
    vocab_size=49_152,
    dtype="float32",
)
