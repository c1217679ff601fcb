"""mamba2-370m [ssm] at its published widths -- the port's own copy of
the JAX package's ``configs/mamba2_370m.py``: attention-free SSD
(state-space duality).  Served in float32, the precision every serving
test of the repository runs in (the JAX config defaults to bfloat16).
[arXiv:2405.21060]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,              # attention-free
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,          # d_inner 2048 -> 32 SSM heads
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=64,             # bounds intra-chunk quadratic memory
    dtype="float32",
)
