"""whisper-small [encdec] at its published widths -- the port's own copy
of the JAX package's ``configs/whisper_small.py``: a 12-layer
bidirectional encoder and a 12-layer causal decoder with
cross-attention, full MHA (12 heads of 64), LayerNorm and GELU MLPs,
sinusoidal encoder and learned decoder positions; the audio frontend is
stubbed (``batch["frames"]``: precomputed frame embeddings).  Served in
float32.  [arXiv:2212.04356]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,          # full MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,        # padded to 51,968
    max_decoder_len=448,
    dtype="float32",
)
