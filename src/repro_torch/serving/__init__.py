"""Serving helpers of the port: the guards and the W8A8 / int8 KV
quantization (the rest of the JAX package's ``serving/`` is a later
slice)."""

from repro_torch.serving.guard import GuardViolation, validate_wz_batch
from repro_torch.serving.quant import (
    dequantize_kv,
    qdot,
    quantize_kv,
    quantize_params,
    quantize_weight,
    verify_step_q,
)

__all__ = ["GuardViolation", "dequantize_kv", "qdot", "quantize_kv",
           "quantize_params", "quantize_weight", "validate_wz_batch",
           "verify_step_q"]
