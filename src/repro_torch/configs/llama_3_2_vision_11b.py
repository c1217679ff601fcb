"""llama-3.2-vision-11b [vlm] at its published widths -- the port's own
copy of the JAX package's ``configs/llama_3_2_vision_11b.py``: a llama
text decoder (32 query heads over 8 KV heads of 128) whose every fifth
layer is a gated cross-attention layer over the image tokens (8 in 40);
the ViT and projector are stubbed (``batch["images"]``: precomputed
patch embeddings).  Served in float32.
[hf:meta-llama/Llama-3.2-11B-Vision]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    cross_attn_period=5,      # 8 cross-attention layers in 40
    num_image_tokens=1600,    # stubbed ViT patch embeddings
    dtype="float32",
)
