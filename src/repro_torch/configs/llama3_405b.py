"""llama3-405b [dense] at its published widths -- the port's own copy of
the JAX package's ``configs/llama3_405b.py``: GQA with 16 query heads per
KV head at head dim 128, a 128k vocabulary.  Served in float32.
[arXiv:2407.21783]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    dtype="float32",
)
