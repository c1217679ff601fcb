"""recurrentgemma-2b [hybrid] at its published widths -- the port's own
copy of the JAX package's ``configs/recurrentgemma_2b.py``: RG-LRU
recurrent blocks and local MQA attention, 2 recurrent : 1 attention, a
window of 2,048 keys at head dim 256.  Served in float32.
[arXiv:2402.19427]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,            # 8 x (rec, rec, attn) + 2 trailing rec
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern_rec=2,
    local_window=2048,
    lru_width=2560,
    dtype="float32",
)
