"""granite-34b [dense] at its published widths -- the port's own copy of
the JAX package's ``configs/granite_34b.py``: a llama-arch code model,
MQA (48 query heads over one KV head) at head dim 128.  Served in
float32, the precision every serving test of the repository runs in.
[arXiv:2405.04324]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,           # MQA
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    dtype="float32",
)
