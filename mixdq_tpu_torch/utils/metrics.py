"""Quality metrics: SQNR, MSE, SSIM, pixel MSE (port of
``mixdq_tpu/utils/metrics.py``).

* SQNR / MSE: the sensitivity sweep's quality metric.
* SSIM: skimage's ``structural_similarity`` with its default uniform
  filter (``channel_axis``, crop-border 'valid' mean, K1 = 0.01, K2 =
  0.03, ``cov_norm = NP / (NP - 1)``), the window a separable f32
  ``cumsum`` whatever its size (the sweep's ``win_size=511`` on 512 px
  images). The order of summation differs from XLA's, so SSIM agrees with
  the JAX package's to a tolerance, not bit for bit.
* pixel MSE: the election metric.

Each returns a 0-d f32 tensor on the inputs' device.
"""

from __future__ import annotations

from typing import Optional

import torch


def mse(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - tgt.float()) ** 2)


def sqnr(signal: torch.Tensor, noisy: torch.Tensor,
         eps: float = 1e-20) -> torch.Tensor:
    """``10 log10(||signal||^2 / ||signal - noisy||^2)`` in dB."""
    s, n = signal.float(), noisy.float()
    p_signal = torch.sum(s ** 2)
    p_noise = torch.sum((s - n) ** 2)
    return 10.0 * torch.log10(p_signal / (p_noise + eps) + eps)


def _box1d(a: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    """Mean over each 'valid' window of ``win`` along ``dim``."""
    c = torch.cumsum(a, dim=dim, dtype=torch.float32)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    c = torch.cat([zero, c], dim)
    n = a.shape[dim]
    return (c.narrow(dim, win, n + 1 - win)
            - c.narrow(dim, 0, n + 1 - win)) / win


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean filter over the last two dims, borders cropped."""
    return _box1d(_box1d(x, win, -1), win, -2)


def ssim(img0: torch.Tensor, img1: torch.Tensor, win_size: int = 7,
         data_range: float = 1.0,
         channel_axis: Optional[int] = -1) -> torch.Tensor:
    """Mean structural similarity of two images (``[H, W, C]`` with
    ``channel_axis=-1``)."""
    x, y = img0.float(), img1.float()
    if channel_axis is not None:
        x = torch.movedim(x, channel_axis, 0)
        y = torch.movedim(y, channel_axis, 0)
    K1, K2 = 0.01, 0.03
    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)
    ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1 = 2.0 * ux * uy + C1
    a2 = 2.0 * vxy + C2
    b1 = ux * ux + uy * uy + C1
    b2 = vx + vy + C2
    return torch.mean((a1 * a2) / (b1 * b2))


def pixel_mse(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Mean pixel MSE of two image batches (the election metric)."""
    return mse(img0, img1)
