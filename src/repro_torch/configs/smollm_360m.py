"""smollm-360m [dense] at its published widths -- the port's own copy of
the JAX package's ``configs/smollm_360m.py``.  Served in float32, the
precision every serving test of the repository runs in.
[hf:HuggingFaceTB/SmolLM-360M]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,           # GQA: 3 query heads per KV head
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    dtype="float32",
)
