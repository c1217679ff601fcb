"""Distributed lossy compression with side information (paper Sec. 5):
``wz`` is the per-sample oracle, ``pipeline`` the batched engine on the
``gls_binned_race`` kernel, ``gaussian`` the synthetic-source experiment
(Fig. 2) and ``vae`` the beta-VAE codec on the synthetic digits with its
training and rate-distortion evaluation (Fig. 4; nets in ``nets``)."""

from repro_torch.compression.gaussian import (GaussianWZ, run_experiment,
                                              simulate_trial)
from repro_torch.compression.pipeline import (WZBatch, batched_race_tables,
                                              check_wz_batch, wz_pipeline,
                                              wz_round_batch)
from repro_torch.compression.vae import (VAETrainConfig, compress_batch,
                                         compress_image, evaluate_rd,
                                         init_vae, train_vae)
from repro_torch.compression.wz import WZCode, make_bins, wz_round

__all__ = [
    "GaussianWZ",
    "VAETrainConfig",
    "WZBatch",
    "WZCode",
    "batched_race_tables",
    "check_wz_batch",
    "compress_batch",
    "compress_image",
    "evaluate_rd",
    "init_vae",
    "make_bins",
    "run_experiment",
    "simulate_trial",
    "train_vae",
    "wz_pipeline",
    "wz_round",
    "wz_round_batch",
]
