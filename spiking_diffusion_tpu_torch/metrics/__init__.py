"""Evaluation metrics of the port: SSIM (``ssim``), FID, IS and KID on
feature arrays (``scores``), the LeNet feature space (``features``) and
its committed frozen copies (``frozen``), and mode coverage
(``mode_coverage``)."""

from spiking_diffusion_tpu_torch.metrics.frozen import (
    data_hash,
    get_feature_space,
    load_frozen_stats,
    verify_stats,
)
from spiking_diffusion_tpu_torch.metrics.mode_coverage import (
    mode_coverage_kl,
    paper_montage,
    per_class_grids,
)
from spiking_diffusion_tpu_torch.metrics.scores import (
    fid_from_features,
    frechet_distance,
    gaussian_stats,
    inception_score_from_probs,
    kid_from_features,
)
from spiking_diffusion_tpu_torch.metrics.ssim import ssim

__all__ = [
    "data_hash",
    "fid_from_features",
    "frechet_distance",
    "gaussian_stats",
    "get_feature_space",
    "inception_score_from_probs",
    "kid_from_features",
    "load_frozen_stats",
    "mode_coverage_kl",
    "paper_montage",
    "per_class_grids",
    "ssim",
    "verify_stats",
]
