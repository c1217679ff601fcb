"""Core coupling library: Gumbel-max List Sampling and its bounds."""

from repro_torch.core.bounds import (
    conditional_lml_bound,
    iid_draft_acceptance_upper,
    lml_bound,
    lml_conditional_bound,
    lml_relaxed_bound,
    maximal_coupling_acceptance,
    single_draft_gumbel_bound,
    tv_distance,
    wz_error_upper_bound,
)
from repro_torch.core.gls import (
    GLSSample,
    exponential_races,
    gls_conditional_decoder,
    gls_conditional_encoder,
    gls_importance_sample,
    gls_sample,
    gls_sample_batch,
    gls_sample_heterogeneous,
)

__all__ = [
    "GLSSample",
    "exponential_races",
    "gls_conditional_decoder",
    "gls_conditional_encoder",
    "gls_importance_sample",
    "gls_sample",
    "gls_sample_batch",
    "gls_sample_heterogeneous",
    "conditional_lml_bound",
    "iid_draft_acceptance_upper",
    "lml_bound",
    "lml_conditional_bound",
    "lml_relaxed_bound",
    "maximal_coupling_acceptance",
    "single_draft_gumbel_bound",
    "tv_distance",
    "wz_error_upper_bound",
]
