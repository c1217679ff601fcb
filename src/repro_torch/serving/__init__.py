"""Serving guards of the port (the rest of the JAX package's
``serving/`` is a later slice)."""

from repro_torch.serving.guard import GuardViolation, validate_wz_batch

__all__ = ["GuardViolation", "validate_wz_batch"]
