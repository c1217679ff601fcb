"""granite-moe-1b-a400m [moe] at its published widths -- the port's own
copy of the JAX package's ``configs/granite_moe_1b_a400m.py``: 32
experts, top-8.  Served in float32.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                 # per-expert FFN width
    vocab_size=49_155,        # padded to 49408 internally
    num_experts=32,
    experts_per_token=8,
    dtype="float32",
)
