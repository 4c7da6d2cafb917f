"""Local model-behavior image metrics: MSE, NRMSE, SSIM.

Port of the JAX package's ``utils/image_metrics.py`` (skimage semantics,
reference unconditional_generation/calculate_local_scores.py:303-374). The
functions take images as the JAX functions do, (B, H, W, C) tensors, and
return one value per image. SSIM uses skimage's defaults: a uniform 7x7
window with VALID padding (``F.avg_pool2d`` over the images permuted to
NCHW, a depthwise mean of each channel), covariances corrected by n/(n-1),
data_range-scaled stability constants, and the channels averaged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image mean squared error over (B, H, W, C)."""
    return torch.mean((a - b) ** 2, dim=(1, 2, 3))


def nrmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normalized RMSE (Euclidean normalization, skimage's default):
    ||a - b|| / ||a||, per image."""
    num = torch.sqrt(torch.sum((a - b) ** 2, dim=(1, 2, 3)))
    den = torch.sqrt(torch.sum(a ** 2, dim=(1, 2, 3)))
    return num / torch.clamp(den, min=1e-12)


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over each size x size window, VALID padding, of (B, C, H, W)."""
    return F.avg_pool2d(x, size, stride=1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Mean SSIM per image of (B, H, W, C) images, channels averaged."""
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1)  # skimage's unbiased covariances
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)

    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    mu_aa = _uniform_filter(a * a, win_size)
    mu_bb = _uniform_filter(b * b, win_size)
    mu_ab = _uniform_filter(a * b, win_size)

    var_a = cov_norm * (mu_aa - mu_a * mu_a)
    var_b = cov_norm * (mu_bb - mu_b * mu_b)
    cov = cov_norm * (mu_ab - mu_a * mu_b)

    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(1, 2, 3))
