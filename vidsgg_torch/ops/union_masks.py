"""Union-box spatial mask rasterizer (counterpart of ``vidsgg/ops/union_masks.py``).

For each pair of boxes (subject ⊕ object, original-image scale, [P, 8])
compute the union window, map each box into an SxS grid over it, and write
the fractional area coverage of the box in each cell. The grid is float32,
as ``vidsgg``'s ``arange``: bfloat16 boxes give float32 masks.
"""

from __future__ import annotations

import torch

from vidsgg_torch.constants import SPATIAL_MASK_SIZE


def _rasterize(box: torch.Tensor, union: torch.Tensor, size: int) -> torch.Tensor:
    """Rasterize one box set [..., 4] into [..., size, size] coverage masks."""
    ux1, uy1, ux2, uy2 = union.unbind(-1)
    eps = torch.tensor(1e-6, dtype=union.dtype)      # JAX's weak-typed scalar
    w = torch.maximum(ux2 - ux1, eps)
    h = torch.maximum(uy2 - uy1, eps)
    x1 = (box[..., 0] - ux1) * size / w
    y1 = (box[..., 1] - uy1) * size / h
    x2 = (box[..., 2] - ux1) * size / w
    y2 = (box[..., 3] - uy1) * size / h

    grid = torch.arange(size, dtype=torch.float32, device=box.device)
    x_cov = torch.clamp(
        torch.minimum(grid + 1.0, x2[..., None]) - torch.maximum(grid, x1[..., None]),
        0.0, 1.0,
    )
    y_cov = torch.clamp(
        torch.minimum(grid + 1.0, y2[..., None]) - torch.maximum(grid, y1[..., None]),
        0.0, 1.0,
    )
    return y_cov[..., :, None] * x_cov[..., None, :]


def draw_union_masks(pair_rois: torch.Tensor, size: int = SPATIAL_MASK_SIZE) -> torch.Tensor:
    """[P, 8] subject⊕object boxes -> [P, 2, size, size] coverage masks.
    The caller subtracts 0.5, as the reference's ``draw_union_boxes(...)-0.5``."""
    sub = pair_rois[..., 0:4]
    obj = pair_rois[..., 4:8]
    union = torch.cat(
        [torch.minimum(sub[..., 0:2], obj[..., 0:2]),
         torch.maximum(sub[..., 2:4], obj[..., 2:4])],
        dim=-1,
    )
    return torch.stack([_rasterize(sub, union, size), _rasterize(obj, union, size)],
                       dim=-3)
