"""FAVOR+ linear attention (Performer) and orthogonal random features
(counterpart of ``vidsgg/models/performer.py``; the reference's optional
TokenGT attention, tools/TokenGT/tokengt/modules/performer_pytorch.py and
orf.py).

* :func:`gaussian_orthogonal_random_matrix`: QR-orthogonalised Gaussian
  blocks, each row scaled to a chi-distributed norm (the norm of an iid
  Gaussian row);
* :func:`favor_attention`: softmax-kernel linear attention,
  phi(x) = exp(w^T x - |x|^2 / 2) / sqrt(m), O(T m d) instead of O(T^2 d),
  with the key padding folded into the kernelised keys.

Every draw comes from a noise source (``noise.py``): the run's in training,
:func:`~vidsgg_torch.models.noise.fixed_noise` at test time. ``vidsgg``
draws from threefry keys, whose normals and chi-square draws no torch
generator reproduces, so the port's draws differ from ``vidsgg``'s by
design; the chi-square of ``nb_cols`` degrees of freedom is the sum of
that many squared normals.
"""

from __future__ import annotations

import math

import torch

from vidsgg_torch.models.promote import result_type, weak


def draw_dtype(like: torch.Tensor) -> torch.dtype:
    """JAX's default float type for a draw: float64 under x64, which the
    port's float64 models stand for, else float32."""
    return torch.float64 if like.dtype == torch.float64 else torch.float32


def gaussian_orthogonal_random_matrix(noise, nb_rows: int, nb_cols: int, batch: int = 1, *,
                                      dtype: torch.dtype, device) -> torch.Tensor:
    """[batch, nb_rows, nb_cols]: ceil(nb_rows / nb_cols) blocks of
    orthonormal rows (the transposed Q of a Gaussian matrix's QR), each row
    scaled by the square root of a chi-square draw of ``nb_cols`` degrees
    of freedom."""
    blocks = []
    for _ in range(-(-nb_rows // nb_cols)):
        q, _ = torch.linalg.qr(noise.normal((batch, nb_cols, nb_cols), dtype, device))
        blocks.append(q.transpose(-1, -2))
    mat = torch.cat(blocks, dim=-2)[:, :nb_rows]
    chi2 = noise.normal((batch, nb_rows, nb_cols), dtype, device).square().sum(-1, keepdim=True)
    return mat * torch.sqrt(chi2)


def _softmax_kernel(x, projection, is_query: bool, eps: float = 1e-4):
    """FAVOR+ positive softmax-kernel features (performer_pytorch.py)."""
    d = x.shape[-1]
    dt = result_type(x, projection)
    scale = torch.tensor(d ** -0.25, dtype=dt)     # 1/sqrt(sqrt(d)) on both sides
    x, proj = x.to(dt) * scale, projection.to(dt) * scale
    wx = torch.einsum("...td,...md->...tm", x, proj)
    sq = (x * x).sum(-1, keepdim=True) / weak(2.0, x)
    stab = wx.amax(dim=-1, keepdim=True) if is_query else wx.amax(dim=(-1, -2), keepdim=True)
    m = projection.shape[-2]
    return (torch.exp(wx - sq - stab) + weak(eps, wx)) / weak(math.sqrt(m), wx)


def favor_attention(q, k, v, key_mask, projection):
    """Linear attention with the softmax kernel. q/k/v: [..., T, d] per head;
    ``key_mask``: [..., T] bool; ``projection``: [m, d] (its caller draws
    it: :func:`gaussian_orthogonal_random_matrix`)."""
    qp = _softmax_kernel(q, projection, is_query=True)
    kp = _softmax_kernel(k, projection, is_query=False) * key_mask[..., None]
    v = v.to(kp.dtype)
    kv = torch.einsum("...tm,...td->...md", kp, v)
    z = 1.0 / (torch.einsum("...tm,...m->...t", qp, kp.sum(-2)) + weak(1e-6, qp))
    return torch.einsum("...tm,...md->...td", qp, kv) * z[..., None]
