"""Image quality metrics and conversions.

Counterpart of `nerf_workspaces_explorer_tpu/utils/metrics.py` (reference
nerf/models/model_utils.py:7-10 for img2mse, mse2psnr and to8b).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def img2mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels/channels."""
    return torch.mean((pred - target) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR in dB for signals in [0, 1]."""
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    """Clamp to [0, 1] and quantize to uint8 (host-side)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255.0 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def ssim(
    img0,
    img1,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Gaussian-windowed SSIM between two [H, W, C] (or [H, W]) images, over
    the window positions that fit inside the image (valid mode), in float64."""
    a = torch.as_tensor(np.asarray(img0), dtype=torch.float64)
    b = torch.as_tensor(np.asarray(img1), dtype=torch.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    coords = torch.arange(filter_size, dtype=torch.float64) - filter_size // 2
    g = torch.exp(-(coords**2) / (2.0 * filter_sigma**2))
    g = g / g.sum()

    def blur(img: torch.Tensor) -> torch.Tensor:
        x = img.permute(2, 0, 1)[:, None]  # [C, 1, H, W]
        x = F.conv2d(x, g.flip(0).view(1, 1, -1, 1))
        x = F.conv2d(x, g.flip(0).view(1, 1, 1, -1))
        return x[:, 0]

    mu0, mu1 = blur(a), blur(b)
    s00 = blur(a * a) - mu0**2
    s11 = blur(b * b) - mu1**2
    s01 = blur(a * b) - mu0 * mu1
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    numer = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    denom = (mu0**2 + mu1**2 + c1) * (s00 + s11 + c2)
    return float(torch.mean(numer / denom))
