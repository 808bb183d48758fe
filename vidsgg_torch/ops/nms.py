"""Masked, fixed-shape greedy non-maximum suppression.

Counterpart of ``vidsgg/ops/nms.py`` and of the TPU kernel
``vidsgg/ops/pallas_nms.py:nms_mask_pallas_batched``. Every NMS of the sgdet
path goes through :func:`nms_mask_batched`: on a CUDA tensor it launches the
hand-written kernel ``csrc/nms.cu``; on a CPU tensor it runs the plain
version :func:`nms_sorted_plain` beside it. Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from vidsgg_torch.ops.cuda_build import CudaKernel

# the H100's per-block shared memory ceiling (227 KB), less static shared
# memory and slack
_SMEM_LIMIT = 232448 - 1024


def _declare(lib):
    lib.vidsgg_nms_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.vidsgg_nms_launch.restype = ctypes.c_int


NMS_KERNEL = CudaKernel("nms.cu", declare=_declare)


def max_boxes_per_problem() -> int:
    """Largest N whose rows fit one block's shared memory (21 bytes a box)."""
    return _SMEM_LIMIT // 21


def nms_sorted_plain(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                     max_keep: int | None = None) -> torch.Tensor:
    """The plain version: greedy scan over ranked boxes, on any device.

    boxes [G, N, 4] float32 and valid [G, N] bool, already in rank order ->
    keep [G, N] bool in the same order. With ``max_keep`` a problem stops at
    its ``max_keep``-th keep or its valid count (exactly its first
    ``max_keep`` keeps are marked), like the kernel.
    """
    g, n = valid.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    suppressed = ~valid
    keep = torch.zeros_like(valid)
    kept = torch.zeros(g, dtype=torch.int64, device=valid.device)
    v_count = valid.sum(1)
    col = torch.arange(n, device=valid.device)
    for i in range(n):
        is_kept = ~suppressed[:, i]
        if max_keep is not None:
            live = (kept < max_keep) & (i < v_count)
            if not bool(live.any()):
                break
            is_kept = is_kept & live
        keep[:, i] = is_kept
        iw = (torch.minimum(x2, x2[:, i:i + 1])
              - torch.maximum(x1, x1[:, i:i + 1]) + 1.0)
        ih = (torch.minimum(y2, y2[:, i:i + 1])
              - torch.maximum(y1, y1[:, i:i + 1]) + 1.0)
        inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
        iou = inter / (area + area[:, i:i + 1] - inter)
        suppressed = suppressed | ((iou > thresh) & (col > i) & is_kept[:, None])
        kept = kept + is_kept
    return keep


def nms_sorted_cuda(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                    max_keep: int | None = None) -> torch.Tensor:
    """The kernel: same contract as :func:`nms_sorted_plain`, CUDA only."""
    if not (boxes.is_cuda and valid.is_cuda and boxes.device == valid.device):
        raise ValueError("nms_sorted_cuda needs boxes and valid on one CUDA device")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"want float32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"want boxes [G, N, 4] and valid [G, N], got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_sorted_cuda needs contiguous inputs")
    g, n = valid.shape
    if n > max_boxes_per_problem():
        raise ValueError(f"N={n} boxes do not fit one block's shared memory "
                         f"(at most {max_boxes_per_problem()})")
    if max_keep is not None and max_keep < 1:
        raise ValueError(f"max_keep must be positive, got {max_keep}")
    if g == 0 or n == 0:
        return torch.zeros((g, n), dtype=torch.bool, device=boxes.device)
    lib = NMS_KERNEL.lib()
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        status = lib.vidsgg_nms_launch(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), g, n,
            float(thresh), int(max_keep or 0), stream,
        )
    NMS_KERNEL.check(status, "nms kernel launch")
    NMS_KERNEL.launches += 1
    return keep


def _ranked(boxes, scores, valid, presorted):
    """[..., N] problems -> flat [G, N] rank-ordered (boxes, valid, order);
    ``order`` is None when already presorted."""
    n = boxes.shape[-2]
    b = boxes.reshape(-1, n, 4).float()
    v = valid.reshape(-1, n).bool()
    if presorted:
        return b.contiguous(), v.contiguous(), None
    s = scores.reshape(-1, n).float()
    neg = torch.full_like(s, torch.finfo(torch.float32).min)
    order = torch.sort(torch.where(v, s, neg), dim=-1, descending=True,
                       stable=True).indices
    bs = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
    return bs.contiguous(), torch.gather(v, 1, order).contiguous(), order


def _unranked(keep_sorted, order, shape):
    if order is not None:
        keep_sorted = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    return keep_sorted.reshape(shape)


def nms_mask_batched_plain(boxes, scores, valid, thresh, max_keep=None,
                           presorted=False):
    """The plain version of :func:`nms_mask_batched`, on any device."""
    bs, vs, order = _ranked(boxes, scores, valid, presorted)
    return _unranked(nms_sorted_plain(bs, vs, thresh, max_keep), order, valid.shape)


def nms_mask_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, thresh: float,
                     max_keep: int | None = None,
                     presorted: bool = False) -> torch.Tensor:
    """Greedy NMS over leading batch axes, the contract of
    ``nms_mask_pallas_batched``.

    boxes [..., N, 4], scores [..., N], valid [..., N] -> keep [..., N] in
    the original order. A kept box suppresses later-ranked boxes with IoU
    strictly greater than ``thresh``. ``presorted``: the boxes are already
    score-descending with valid ones first (straight from a top-k), so the
    sort and the scatter back are skipped. ``max_keep``: only the first
    ``max_keep`` keeps of each problem are marked.
    """
    if boxes.is_cuda:
        bs, vs, order = _ranked(boxes, scores, valid, presorted)
        return _unranked(nms_sorted_cuda(bs, vs, thresh, max_keep), order, valid.shape)
    if boxes.device.type == "cpu":
        return nms_mask_batched_plain(boxes, scores, valid, thresh, max_keep, presorted)
    raise ValueError(f"no NMS for device {boxes.device}")


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float) -> torch.Tensor:
    """Single-problem greedy NMS: boxes [N, 4] -> keep [N] in original order."""
    return nms_mask_batched(boxes[None], scores[None], valid[None], iou_thresh)[0]


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor,
                      valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """NMS over leading batch axes (e.g. [frames, classes, N])."""
    return nms_mask_batched(boxes, scores, valid, iou_thresh)
