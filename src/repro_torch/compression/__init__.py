"""Distributed lossy compression with side information (paper Sec. 5):
``wz`` is the per-sample oracle, ``pipeline`` the batched engine on the
``gls_binned_race`` kernel, ``gaussian`` the synthetic-source experiment.
The beta-VAE/MNIST experiment of the JAX package comes with training."""

from repro_torch.compression.gaussian import (GaussianWZ, run_experiment,
                                              simulate_trial)
from repro_torch.compression.pipeline import (WZBatch, batched_race_tables,
                                              check_wz_batch, wz_pipeline,
                                              wz_round_batch)
from repro_torch.compression.wz import WZCode, make_bins, wz_round

__all__ = [
    "GaussianWZ",
    "WZBatch",
    "WZCode",
    "batched_race_tables",
    "check_wz_batch",
    "make_bins",
    "run_experiment",
    "simulate_trial",
    "wz_pipeline",
    "wz_round",
    "wz_round_batch",
]
