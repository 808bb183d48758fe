"""Masked batched normalized-Laplacian eigendecomposition (counterpart of
``vidsgg/ops/laplacian.py``).

L = I - D^{-1/2} A D^{-1/2} with in-degrees clipped to >= 1 (the
reference's convention, lib/teatgt.py:248-253). Padding nodes get a huge
diagonal (``_PAD_DIAG``) so their eigenpairs sort to the end of the
ascending spectrum, and their rows of the eigenvectors are zeroed; the first
``num_valid`` columns then belong to the true graph. Eigenvector signs and
the basis inside a repeated eigenvalue's eigenspace are arbitrary, and every
LAPACK or cuSOLVER build picks its own: only the eigenvalues and the
projector onto each eigenspace are stable across implementations.
"""

from __future__ import annotations

import torch

_PAD_DIAG = 1e6


def masked_laplacian_eig(adj: torch.Tensor, node_mask: torch.Tensor):
    """Eigendecomposition of the sym-normalized Laplacian of a masked graph.

    Args:
      adj: [..., N, N] dense (possibly weighted) adjacency; entries touching
        padding nodes are ignored.
      node_mask: [..., N] bool validity of each node.

    Returns:
      (eigval [..., N], eigvec [..., N, N]) in ascending eigenvalue order, in
      ``adj``'s dtype. Rows of padding nodes are zeroed; the trailing columns
      belonging to padding carry eigenvalue ~``_PAD_DIAG``.
    """
    mask_f = node_mask.to(adj.dtype)
    a = adj * (mask_f[..., :, None] * mask_f[..., None, :])
    deg = torch.clamp(a.sum(dim=-2), min=1.0)   # in-degrees, clipped like the reference
    d_isqrt = torch.where(node_mask, 1.0 / torch.sqrt(deg), torch.zeros_like(deg))
    lap = -a * d_isqrt[..., :, None] * d_isqrt[..., None, :]
    diag = torch.where(node_mask, torch.ones_like(deg), torch.full_like(deg, _PAD_DIAG))
    n = adj.shape[-1]
    lap = lap + diag[..., :, None] * torch.eye(n, dtype=adj.dtype, device=adj.device)
    # jnp.linalg.eigh symmetrizes its input; torch's reads one triangle
    lap = (lap + lap.transpose(-1, -2)) / 2
    eigval, eigvec = torch.linalg.eigh(lap)
    return eigval, eigvec * mask_f[..., :, None]
