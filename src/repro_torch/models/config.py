"""Model configuration for the port: the JAX package's
``models/config.py::ModelConfig`` (the same six families, field names,
derived sizes and ``reduced()`` smoke variants), with ``dtype`` kept as
a string and resolved to a torch dtype on demand."""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A dense llama-family decoder (GQA + RoPE + SwiGLU + RMSNorm, an
    optional sliding window), its mixture-of-experts variant
    (``family="moe"``), a Mamba-2 SSM (``family="ssm"``, attention-free:
    ``num_heads`` 0), the RG-LRU hybrid (``family="hybrid"``), the
    Whisper encoder-decoder (``family="encdec"``) or the Llama-3.2-Vision
    decoder with gated cross-attention (``family="vlm"``).

    ``padded_vocab`` rounds the embedding/logit dim up to a multiple of
    256 exactly as the JAX config does, so converted parameter trees
    line up and samplers slice the true vocabulary off the same width.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention (mixtral: 4096)
    max_seq_len: int = 1 << 20
    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    # SSM (Mamba-2 / SSD), the JAX defaults.
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # Hybrid (recurrentgemma): a unit is `pattern_rec` RG-LRU blocks and
    # one local-attention block over a window of `local_window` keys.
    pattern_rec: int = 0
    local_window: int = 0
    lru_width: int = 0
    # Encoder-decoder (whisper): encoder depth; the decoder's positions
    # and self-cache stop at `max_decoder_len`.
    encoder_layers: int = 0
    max_decoder_len: int = 448
    # VLM (llama-3.2-vision): one gated cross-attention layer closes every
    # `cross_attn_period` layers; the stubbed image patch embeddings.
    cross_attn_period: int = 0
    num_image_tokens: int = 0
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.num_heads <= 0:
            raise ValueError(f"{self.name}: num_heads required")
        if self.dtype not in _DTYPES:
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family, tiny but structurally
        alike: JAX's ``reduced()`` (``repro/models/config.py:104``), so
        both packages build the same small models."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=4096,
            dtype="float32",
        )
        if self.num_heads:
            heads = min(self.num_heads, 4)
            kv = max(1, min(self.kv_heads, heads))
            while heads % kv:
                kv -= 1
            kw.update(num_heads=heads, num_kv_heads=kv, head_dim=64)
        if self.num_experts:
            kw.update(num_experts=min(self.num_experts, 4),
                      experts_per_token=min(self.experts_per_token, 2))
        if self.family == "ssm":
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                      ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(num_layers=3, local_window=64,
                      lru_width=min(self.lru_width or self.d_model, 256))
        if self.family == "encdec":
            kw.update(encoder_layers=2, max_decoder_len=64)
        if self.family == "vlm":
            kw.update(num_layers=5, cross_attn_period=self.cross_attn_period,
                      num_image_tokens=16)
        if self.sliding_window:
            kw.update(sliding_window=64)
        return self.replace(**kw)
