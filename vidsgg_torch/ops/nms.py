"""Masked, fixed-shape greedy non-maximum suppression.

Counterpart of ``vidsgg/ops/nms.py``, of the TPU kernels
``vidsgg/ops/pallas_nms.py:nms_mask_pallas_batched`` and ``nms_mask_pallas``,
and of ``vidsgg/models/postprocess_device.py:_grouped_nms``. Every NMS of
the sgdet path goes through :func:`nms_mask_batched` or :func:`grouped_nms`:
on a CUDA tensor they launch the hand-written kernel ``csrc/nms.cu``; on a
CPU tensor they run the plain versions beside it (:func:`nms_sorted_plain`).
Any other device raises.

The grouped call takes bfloat16 boxes and scores in bfloat16 serving (the
kernel's bfloat16 route: every operation of the IoU rounded to bfloat16,
as torch and XLA round it, and the threshold rounded to bfloat16, as a
weak-typed Python float is in JAX); the RPN and class-grid calls stay
float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vidsgg_torch.ops.cuda_build import CudaKernel

# the H100's per-block shared memory ceiling (227 KB), less the kernel's
# static shared memory and slack
_SMEM_LIMIT = 232448 - 1024
# the kernel ranks a problem itself up to this many boxes (one block's
# bitonic sort); a longer unsorted problem is ranked by torch first
MAX_RANKED = 1024


def _declare(lib):
    lib.vidsgg_nms_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.vidsgg_nms_launch.restype = ctypes.c_int
    lib.vidsgg_nms_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.vidsgg_nms_smem_bytes.restype = ctypes.c_longlong


# ``launches`` counts every launch; ``launches_by`` splits them by the
# caller's contract: "presorted" (the RPN call), "ranked" (ranking inside
# the call, the class grid: K2's contract) and "grouped";
# ``launches_by_dtype`` by contract and the boxes' dtype ("grouped bfloat16")
NMS_KERNEL = CudaKernel("nms.cu", declare=_declare)
KERNEL_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def smem_bytes(n: int, dtype: torch.dtype = torch.float32, max_keep: int | None = None,
               grouped: bool = False, ranked: bool = False) -> int:
    """Dynamic shared memory one block of the kernel needs (loads the kernel)."""
    item = torch.empty((), dtype=dtype).element_size()
    return NMS_KERNEL.lib().vidsgg_nms_smem_bytes(item, n, max_keep or 0, int(grouped),
                                                  int(ranked))


def nms_sorted_plain(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                     max_keep: int | None = None,
                     group: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: greedy scan over ranked boxes, on any device.

    boxes [G, N, 4] (float32, float64 or bfloat16, kept as given: each
    operation of the IoU rounds to that type, as torch computes it, and the
    threshold is taken in that type) and valid [G, N] bool, already in rank
    order -> keep [G, N] bool in the same order. With
    ``group`` [G, N] a kept box suppresses only boxes of its own group.
    With ``max_keep`` a problem stops at its ``max_keep``-th keep or its
    valid count (exactly its first ``max_keep`` keeps are marked), like the
    kernel.
    """
    g, n = valid.shape
    thr = torch.tensor(thresh, dtype=boxes.dtype)
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
        hit = (iou > thr) & (col > i) & is_kept[:, None]
        if group is not None:
            hit = hit & (group == group[:, i:i + 1])
        suppressed = suppressed | hit
        kept = kept + is_kept
    return keep


def _kernel(boxes, valid, thresh, contract, *, scores=None, fill=0.0, group=None,
            max_keep=None, want_rank=False):
    """One launch of ``csrc/nms.cu`` over [G, N] problems on one CUDA device.

    boxes [G, N, 4] float32/float64/bfloat16, valid [G, N] bool, group
    [G, N] or None. ``scores`` None: the boxes are in rank order. Otherwise the kernel
    ranks them by ``where(valid, scores, fill)``, descending, ties by index
    (N <= ``MAX_RANKED``), marks keep in the input order and, with
    ``want_rank``, returns each box's rank. -> (keep [G, N] bool, rank
    [G, N] int32 or None)."""
    tensors = [t for t in (boxes, valid, scores, group) if t is not None]
    dev = boxes.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("the NMS kernel needs all its inputs on one CUDA device")
    if boxes.dtype not in KERNEL_DTYPES or valid.dtype != torch.bool:
        raise TypeError(f"want float32/float64/bfloat16 boxes and bool valid, got "
                        f"{boxes.dtype}, {valid.dtype}")
    if scores is not None and scores.dtype != boxes.dtype:
        raise TypeError(f"scores {scores.dtype} differ from boxes {boxes.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"want boxes [G, N, 4] and valid [G, N], got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    for t in (scores, group):
        if t is not None and t.shape != valid.shape:
            raise ValueError(f"want [G, N] = {tuple(valid.shape)}, got {tuple(t.shape)}")
    if max_keep is not None and max_keep < 1:
        raise ValueError(f"max_keep must be positive, got {max_keep}")
    g, n = valid.shape
    if scores is not None and n > MAX_RANKED:
        raise ValueError(f"the kernel ranks at most {MAX_RANKED} boxes, got N={n}")
    lib = NMS_KERNEL.lib()
    need = smem_bytes(n, boxes.dtype, max_keep, group is not None, scores is not None)
    if need > _SMEM_LIMIT:
        raise ValueError(f"N={n} needs {need} bytes of shared memory, over one block's "
                         f"{_SMEM_LIMIT} (the kept list holds max_keep or N boxes)")
    keep = torch.empty((g, n), dtype=torch.bool, device=dev)
    rank = torch.empty((g, n), dtype=torch.int32, device=dev) if want_rank else None
    if g == 0 or n == 0:
        return keep, rank
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:          # cp.async copies 16-byte rows
        boxes = boxes.clone()
    valid = valid.contiguous()
    if scores is not None:
        scores = scores.contiguous()
    if group is not None:
        group = group.to(torch.int64).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the threshold in the boxes' type (bfloat16(0.6) = 0.6015625), passed
    # as a value the kernel's type holds exactly
    thresh = float(torch.tensor(thresh, dtype=boxes.dtype))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vidsgg_nms_launch(
            boxes.element_size(), boxes.data_ptr(), ptr(scores), valid.data_ptr(),
            ptr(group), keep.data_ptr(), ptr(rank), g, n, thresh, float(fill),
            int(max_keep or 0), stream,
        )
    NMS_KERNEL.check(status, "nms kernel launch")
    NMS_KERNEL.count(contract, str(boxes.dtype).removeprefix("torch."))
    return keep, rank


def nms_sorted_cuda(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                    max_keep: int | None = None, group: torch.Tensor | None = None,
                    contract: str = "presorted") -> torch.Tensor:
    """The kernel over ranked boxes: the contract of
    :func:`nms_sorted_plain`, CUDA only."""
    return _kernel(boxes, valid, thresh, contract, group=group, max_keep=max_keep)[0]


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
    ``nms_mask_pallas_batched`` (and, without ``max_keep`` and
    ``presorted``, of ``nms_mask_pallas``).

    boxes [..., N, 4] (cast to float32), scores [..., N], valid [..., N] ->
    keep [..., N] in the original order. A kept box suppresses later-ranked
    boxes with IoU strictly greater than ``thresh``. ``presorted``: the
    boxes are already score-descending with valid ones first (straight from
    a top-k), so nothing is ranked. ``max_keep``: only the first
    ``max_keep`` keeps of each problem are marked.
    """
    if boxes.is_cuda:
        n = boxes.shape[-2]
        if presorted or n > MAX_RANKED:
            contract = "presorted" if presorted else "ranked"
            bs, vs, order = _ranked(boxes, scores, valid, presorted)
            keep = nms_sorted_cuda(bs, vs, thresh, max_keep, contract=contract)
            return _unranked(keep, order, valid.shape)
        b = boxes.reshape(-1, n, 4).float()
        s = scores.reshape(-1, n).float()
        v = valid.reshape(-1, n).bool()
        keep, _ = _kernel(b, v, thresh, "ranked", scores=s,
                          fill=torch.finfo(torch.float32).min, max_keep=max_keep)
        return keep.reshape(valid.shape)
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


def _grouped_by_torch_rank(boxes4, scores, group, valid, thresh, scan):
    """Rank with a stable torch sort on ``where(valid, -scores, inf)`` (the
    order of ``vidsgg``'s ``_grouped_nms``), scan with ``scan``, map back."""
    m = valid.shape[0]
    inf = torch.full_like(scores, float("inf"))
    order = torch.sort(torch.where(valid, -scores, inf), stable=True).indices
    keep_sorted = scan(boxes4[order][None].contiguous(), valid[order][None].contiguous(),
                       thresh, group=group[order][None])[0]
    keep = torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)
    rank = torch.empty(m, dtype=torch.int32, device=valid.device).scatter(
        0, order, torch.arange(m, dtype=torch.int32, device=valid.device))
    return keep, rank


def grouped_nms_plain(boxes4, scores, group, valid, thresh):
    """The plain version of :func:`grouped_nms`, on any device."""
    return _grouped_by_torch_rank(boxes4, scores, group, valid, thresh, nms_sorted_plain)


def grouped_nms(boxes4: torch.Tensor, scores: torch.Tensor, group: torch.Tensor,
                valid: torch.Tensor, thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one problem restricted to same-group boxes, the
    contract of ``vidsgg``'s ``postprocess_device._grouped_nms``.

    boxes4 [M, 4] (float32, float64 or bfloat16, IoU in that type), scores
    [M] of the same type, group [M] integer ids, valid [M] bool -> (keep [M] bool, rank [M]
    int32): ``rank`` is each slot's position in the stable score-descending
    order, invalid slots last in index order. A kept box suppresses a
    later-ranked box of its group whose IoU is strictly greater than
    ``thresh``.
    """
    if boxes4.is_cuda:
        m = valid.shape[0]
        if m > MAX_RANKED:
            scan = functools.partial(nms_sorted_cuda, contract="grouped")
            return _grouped_by_torch_rank(boxes4, scores, group, valid, thresh, scan)
        # ranked by where(valid, scores, -inf) descending: the same order
        keep, rank = _kernel(boxes4[None], valid[None], thresh, "grouped",
                             scores=scores[None], fill=float("-inf"),
                             group=group[None], want_rank=True)
        return keep[0], rank[0]
    if boxes4.device.type == "cpu":
        return grouped_nms_plain(boxes4, scores, group, valid, thresh)
    raise ValueError(f"no grouped NMS for device {boxes4.device}")
