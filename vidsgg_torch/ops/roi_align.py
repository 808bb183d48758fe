"""ROIAlign as interpolation matrices (counterpart of ``vidsgg/ops/roi_align.py``).

Semantics of the torchvision/jwyang ROIAlign (aligned=False) with the
reference's ``sampling_ratio=0``, the only one the path uses: each bin
averages ceil(bin_size) samples per axis, clipped at ``max_samples`` (16).
Bilinear pooling is separable, so each roi's output is ``Ay @ F @ Ax^T``
with dense row-interpolation matrices whose rows already average the bin's
samples. The interpolation weights are
computed in float32 from float32 rois, as in ``vidsgg``; the products are
plain matrix multiplies (``vidsgg`` leaves them to XLA, not to a kernel).

Types follow ``vidsgg``'s: without a ``compute_dtype`` the product runs in
the promotion of float32 (the weights) and the features' type, and the
result is cast to the features' type (bfloat16 union maps pool in float32
and round once). With ``compute_dtype`` (the bfloat16 detector's box
pooling) features and weights are cast to it, and so is the product of the
two axis weights; the product's output is then rounded to that type too,
where ``vidsgg`` keeps the float32 sum (the head's first convolution
rounds it to the same value).

Public layout: features ``[B, H, W, C]`` (NHWC, as in ``vidsgg``). A
permuted view of an NCHW tensor is taken as it is, without a copy, where
the product allows it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _interp_matrix(starts, bin_sizes, out_size, s, dim, grid):
    """Average-of-samples bilinear interpolation rows.

    starts/bin_sizes: [..., K] roi starts and bin sizes (feature coords).
    grid: [..., K] adaptive sample counts in [1, s]; sample slots >= grid
      are masked out and the average divides by grid.
    Returns [..., K, out_size, dim] weights.
    """
    dev = starts.device
    f32 = torch.float32
    slot = torch.arange(s, dtype=f32, device=dev)
    g = grid.to(f32)[..., None]                              # [..., K, 1]
    offs = (slot + 0.5) / g                                  # [..., K, s]
    slot_valid = (slot < g).to(f32)
    denom = g[..., None]                                     # [..., K, 1, 1]
    pos = (
        starts[..., None, None]
        + (torch.arange(out_size, dtype=f32, device=dev)[:, None] + offs[..., None, :])
        * bin_sizes[..., None, None]
    )                                                        # [..., K, out, s]
    valid = (pos >= -1.0) & (pos <= dim)
    pc = pos.clamp(0.0, dim - 1.0)
    p0 = torch.floor(pc)
    frac = pc - p0
    idx = torch.arange(dim, dtype=f32, device=dev)
    w0 = (idx == p0[..., None]).to(f32) * (1.0 - frac[..., None])
    p1 = torch.clamp(p0 + 1.0, max=dim - 1.0)
    w1 = (idx == p1[..., None]).to(f32) * frac[..., None]
    w = (w0 + w1) * valid[..., None].to(f32) * slot_valid[..., None, :, None]
    return w.sum(dim=-2) / denom


def _axis_weights(rois4, out_size, spatial_scale, max_samples, h, w):
    """rois [..., K, 4] (image scale) -> (Ay [..., K, m, H], Ax [..., K, m, W]),
    with ceil(bin size) samples per bin and axis (``sampling_ratio=0``)."""
    m = out_size
    x1 = rois4[..., 0] * spatial_scale
    y1 = rois4[..., 1] * spatial_scale
    x2 = rois4[..., 2] * spatial_scale
    y2 = rois4[..., 3] * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / m
    bin_h = torch.clamp(y2 - y1, min=1.0) / m
    gy = torch.clamp(torch.ceil(bin_h), 1.0, float(max_samples))
    gx = torch.clamp(torch.ceil(bin_w), 1.0, float(max_samples))
    ay = _interp_matrix(y1, bin_h, m, max_samples, h, gy)
    ax = _interp_matrix(x1, bin_w, m, max_samples, w, gx)
    return ay, ax


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0 / 16.0, chunk_size: int = 128,
              max_samples: int = 16) -> torch.Tensor:
    """features [B, H, W, C] + rois [R, 5] (batch_idx, x1, y1, x2, y2) ->
    [R, out_size, out_size, C] in the features dtype.

    The batch selection folds into the row matrix over the flattened (B*H)
    axis; rois are pooled ``chunk_size`` at a time to bound the
    [chunk*m, W*C] intermediate.
    """
    b, h, w, c = features.shape
    m = out_size
    cdt = torch.promote_types(torch.float32, features.dtype)
    flat = features.reshape(b * h, w * c).to(cdt)
    rois = rois.float()
    outs = []
    for chunk in torch.split(rois, chunk_size):
        k = chunk.shape[0]
        ay, ax = _axis_weights(chunk[:, 1:5], m, spatial_scale, max_samples, h, w)
        onehot = F.one_hot(chunk[:, 0].long(), b).to(torch.float32)   # [K, B]
        ay_embed = (onehot[:, None, :, None] * ay[:, :, None, :]).reshape(k * m, b * h)
        t1 = torch.matmul(ay_embed.to(cdt), flat).reshape(k, m, w, c)
        out = torch.einsum("kmwc,knw->kmnc", t1, ax.to(cdt))
        outs.append(out.to(features.dtype))
    if not outs:
        return features.new_zeros((0, m, m, c))
    return torch.cat(outs, dim=0)


def roi_align_fused(features: torch.Tensor, rois: torch.Tensor,
                    out_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                    compute_dtype=None, max_samples: int = 16) -> torch.Tensor:
    """Per-frame ROIAlign as one product per frame: features [B, H, W, C] +
    rois [B, N, 4] -> [B, N, m, m, C].

    The y- and x-rows combine into per-roi bin weights W2 [N*m*m, H*W] and
    pooling is W2 @ F[b] with F[b] viewed as [H*W, C]. ``compute_dtype``
    (the detector's, when it is not float32) is the product's type; the
    result keeps the features' type, as in ``vidsgg``.
    """
    b, h, w, c = features.shape
    n = rois.shape[1]
    m = out_size
    out_dtype = features.dtype
    cdt = (torch.promote_types(torch.float32, features.dtype) if compute_dtype is None
           else compute_dtype)
    feats = features.to(cdt)
    ay, ax = _axis_weights(rois.float(), m, spatial_scale, max_samples, h, w)
    ay, ax = ay.to(cdt), ax.to(cdt)
    w2 = (ay[:, :, :, None, :, None] * ax[:, :, None, :, None, :]).reshape(
        b, n * m * m, h * w)
    # [B, C, H*W] from the NCHW storage a permuted view carries
    fm = feats.permute(0, 3, 1, 2).reshape(b, c, h * w)
    out = torch.matmul(w2, fm.transpose(1, 2))                # [B, N*m*m, C]
    return out.reshape(b, n, m, m, c).to(out_dtype)
