"""mixtral-8x22b [moe] at its published widths -- the port's own copy of
the JAX package's ``configs/mixtral_8x22b.py``: 8 experts, top-2, and
sliding-window attention over 4,096 keys.  Served in float32.
[arXiv:2401.04088]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    dtype="float32",
)
