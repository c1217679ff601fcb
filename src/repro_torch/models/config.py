"""Model configuration for the port: the dense and SSM subset of the JAX
package's ``models/config.py::ModelConfig`` (same field names, same
derived sizes; full attention only, no sliding window), with ``dtype``
kept as a string and resolved to a torch dtype on demand."""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


FAMILIES = ("dense", "ssm")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A dense llama-family decoder (GQA + RoPE + SwiGLU + RMSNorm) or a
    Mamba-2 SSM (``family="ssm"``, attention-free: ``num_heads`` 0).

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
    # SSM (Mamba-2 / SSD), the JAX defaults.
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
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
            raise ValueError(
                f"{self.name}: the port serves the dense and ssm families "
                "only (the others are ROADMAP queue 1, item 15)")
        if self.family != "ssm" and self.num_heads <= 0:
            raise ValueError(f"{self.name}: num_heads required")
        if self.dtype not in _DTYPES:
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
