"""FID and CLIP-score math (port of ``mixdq_tpu/utils/fid.py``).

* ``frechet_distance(mu1, cov1, mu2, cov2)``: the Frechet distance of two
  feature Gaussians, in float32 as the JAX package computes it, with a
  symmetric-eigendecomposition matrix square root (``torch.linalg.eigh``,
  eigenvalues clipped at 1e-10) and the cross term in the
  similarity-transformed PSD form ``(S1 C2 S1)^{1/2}``, ``S1 = C1^{1/2}``
  (no scipy ``sqrtm``, no float64: either computes another function).
* ``fid_from_features(feats_a, feats_b)``: fit both Gaussians, then the
  distance.
* ``clip_score(image_embeds, text_embeds)``: mean of ``100 * max(cos,
  0)`` over paired rows.

Inputs are numpy arrays or tensors; the math runs on the tensors' device
(the CPU for numpy inputs).
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _sqrtm_psd(mat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Matrix square root of a symmetric PSD matrix by ``eigh``."""
    vals, vecs = torch.linalg.eigh(mat)
    vals = vals.clamp(min=eps)
    return (vecs * vals.sqrt()[None, :]) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> torch.Tensor:
    """``||mu1 - mu2||^2 + Tr(cov1 + cov2 - 2 (cov1 cov2)^{1/2})``, a 0-d
    f32 tensor."""
    mu1, mu2, cov1, cov2 = (_f32(v) for v in (mu1, mu2, cov1, cov2))
    diff = mu1 - mu2
    s1 = _sqrtm_psd(cov1)
    tr_cross = torch.trace(_sqrtm_psd(s1 @ cov2 @ s1))
    return diff @ diff + torch.trace(cov1) + torch.trace(cov2) - 2.0 * tr_cross


def fit_gaussian(feats: torch.Tensor):
    """``feats`` ``[N, D]`` -> (mu ``[D]``, cov ``[D, D]``, unbiased)."""
    mu = feats.mean(0)
    x = feats - mu[None, :]
    return mu, (x.T @ x) / (feats.shape[0] - 1)


def fid_from_features(feats_a, feats_b) -> float:
    mu1, c1 = fit_gaussian(_f32(feats_a))
    mu2, c2 = fit_gaussian(_f32(feats_b))
    return float(frechet_distance(mu1, c1, mu2, c2))


def clip_score(image_embeds, text_embeds) -> float:
    """Mean ``100 * max(cos(img, txt), 0)`` over paired rows."""
    a, b = _f32(image_embeds), _f32(text_embeds)
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    cos = (a * b).sum(-1)
    return float(100.0 * cos.clamp(min=0.0).mean())
