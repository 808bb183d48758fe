"""Vectorized scene-graph construction for TEAT-GT (counterpart of
``vidsgg/models/graph_build.py``, the reference's lib/teatgt.py:103-274).

* node tokens: one person token per frame (the subject of the frame's first
  pair) and one object token per pair, ordered frame-major with the person
  first;
* 5-frame clips; a clip keeps its first ``tokens_per_clip`` tokens;
* spatial edges: same-frame tokens with bbox-center distance <= threshold;
  temporal edges: adjacent-frame tokens with cosine similarity >= 0.75;
  both directions; a (0,1)/(1,0) fallback when a clip has no edge.

Dense masks over fixed-capacity token axes. Every tie order is
``vidsgg``'s: stable sorts, ``searchsorted`` on the left, the first pair of
a frame by ``argmax``; its out-of-range scatters (``mode="drop"``) write
into one extra dump row that is sliced off.
"""

from __future__ import annotations

import dataclasses

import torch

from vidsgg_torch.data.entry import Entry
from vidsgg_torch.models.promote import weak


@dataclasses.dataclass(frozen=True)
class ClipCaps:
    """Static TEAT-GT capacities."""

    clip_size: int = 5
    n_clips: int = 4            # >= ceil(max_frames / clip_size)
    tokens_per_clip: int = 24   # >= clip_size * (1 + max objs per frame)
    edges_per_clip: int = 128   # directed edges
    tokens_per_frame: int = 8   # for the per-frame regularizer graphs


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Global token axis (persons then pair objects) and its clip routing."""

    # global token axis, size F + P
    token_frame: torch.Tensor      # [T]
    token_valid: torch.Tensor      # [T]
    token_center: torch.Tensor     # [T, 2]
    token_is_person: torch.Tensor  # [T]
    token_box: torch.Tensor        # [T] box index providing the 2048-d feature
    token_label: torch.Tensor      # [T] class label for the label embedding
    token_pair: torch.Tensor       # [T] pair id of object tokens (0 otherwise)
    # clip routing
    clip_tokens: torch.Tensor      # [n_clips, Tc] indices into the token axis
    clip_mask: torch.Tensor        # [n_clips, Tc]
    # frame routing (the train-time regularizer)
    frame_tokens: torch.Tensor     # [F, Tf]
    frame_mask: torch.Tensor       # [F, Tf]


def _route(order, sorted_valid, group_of_sorted, n_groups: int, cap: int):
    """Slot frame-sorted tokens into per-group rows of ``cap`` slots."""
    t = order.shape[0]
    dev = order.device
    grp = torch.where(sorted_valid, group_of_sorted,
                      torch.full_like(group_of_sorted, n_groups))
    # rank within group = position - first position of the group
    first = torch.searchsorted(grp.contiguous(), torch.arange(n_groups, device=dev,
                                                              dtype=grp.dtype), side="left")
    slot = torch.arange(t, device=dev) - first[torch.clamp(grp, 0, n_groups - 1)]
    ok = sorted_valid & (slot >= 0) & (slot < cap)
    gi = torch.where(ok, grp, torch.full_like(grp, n_groups))   # row n_groups: dump
    si = torch.where(ok, slot, torch.zeros_like(slot))
    idx = torch.zeros((n_groups + 1, cap), dtype=torch.int32, device=dev)
    msk = torch.zeros((n_groups + 1, cap), dtype=torch.bool, device=dev)
    idx[gi, si] = order.to(torch.int32)
    msk[gi, si] = ok
    return idx[:n_groups], msk[:n_groups]


def build_token_layout(entry: Entry, caps: ClipCaps) -> TokenLayout:
    f_cap = entry.frame_mask.shape[0]
    p_cap = entry.pair_mask.shape[0]
    dev = entry.pair_mask.device
    im_idx = entry.im_idx.long()
    pair_idx = entry.pair_idx.long()

    # person token per frame: the subject of the frame's first pair
    frames = torch.arange(f_cap, device=dev)
    has_pair = (im_idx[None, :] == frames[:, None]) & entry.pair_mask[None, :]
    person_exists = has_pair.any(dim=1)
    first_pair = torch.argmax(has_pair.to(torch.uint8), dim=1)  # the first max, as jnp.argmax

    person_box = pair_idx[first_pair, 0]
    object_box = pair_idx[:, 1]

    token_frame = torch.cat([frames, im_idx])
    token_valid = torch.cat([person_exists, entry.pair_mask])
    token_is_person = torch.cat([torch.ones(f_cap, dtype=torch.bool, device=dev),
                                 torch.zeros(p_cap, dtype=torch.bool, device=dev)])
    token_box = torch.cat([person_box, object_box])
    token_label = entry.pred_labels.long()[token_box]
    token_pair = torch.cat([torch.zeros(f_cap, dtype=torch.long, device=dev),
                            torch.arange(p_cap, device=dev)])

    b = entry.boxes[token_box, 1:]
    token_center = torch.stack([(b[:, 0] + b[:, 2]) / 2.0, (b[:, 1] + b[:, 3]) / 2.0], dim=1)

    # frame-major stable order, person (low global index) before objects
    big = f_cap + caps.n_clips * caps.clip_size + 1
    order = torch.sort(torch.where(token_valid, token_frame, torch.full_like(token_frame, big)),
                       stable=True).indices
    sorted_valid = token_valid[order]
    sorted_frame = torch.where(sorted_valid, token_frame[order],
                               torch.full_like(token_frame, big))

    clip_tokens, clip_mask = _route(order, sorted_valid, sorted_frame // caps.clip_size,
                                    caps.n_clips, caps.tokens_per_clip)
    frame_tokens, frame_mask = _route(order, sorted_valid, sorted_frame, f_cap,
                                      caps.tokens_per_frame)
    return TokenLayout(
        token_frame=token_frame, token_valid=token_valid, token_center=token_center,
        token_is_person=token_is_person, token_box=token_box, token_label=token_label,
        token_pair=token_pair, clip_tokens=clip_tokens, clip_mask=clip_mask,
        frame_tokens=frame_tokens, frame_mask=frame_mask,
    )


def clip_edge_masks(frames, centers, feats, mask, edge_thr, sim_thr: float = 0.75):
    """Dense (spatial, temporal) directed-edge masks per clip.

    Args:
      frames: [B, Tc] clip-rebased frame per token.
      centers: [B, Tc, 2].
      feats: [B, Tc, D] tokens for the cosine similarity.
      mask: [B, Tc].
      edge_thr: [] or [B] spatial distance threshold.
    """
    vv = mask[:, :, None] & mask[:, None, :]
    not_self = ~torch.eye(mask.shape[-1], dtype=torch.bool, device=mask.device)[None]
    same_frame = frames[:, :, None] == frames[:, None, :]
    d2 = ((centers[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    d = torch.sqrt(d2 + weak(1e-12, d2))
    edge_thr = torch.as_tensor(edge_thr, device=d.device)
    if edge_thr.dim() == 1:
        edge_thr = edge_thr[:, None, None]
    spatial = vv & not_self & same_frame & (d <= edge_thr)

    sq = (feats * feats).sum(-1, keepdim=True)
    nrm = feats * torch.rsqrt(sq + weak(1e-12, sq))
    cos = torch.einsum("bid,bjd->bij", nrm, nrm)
    next_frame = frames[:, None, :] == frames[:, :, None] + 1
    temporal_fwd = vv & next_frame & (cos >= sim_thr)
    temporal = temporal_fwd | temporal_fwd.transpose(1, 2)
    return spatial, temporal


def masks_to_edge_list(spatial, temporal, edges_cap: int):
    """Dense masks -> padded (edge_index [B, E, 2], edge_type [B, E],
    edge_mask [B, E], adjacency [B, Tc, Tc] float32), with the reference's
    empty-clip fallback edge (0,1)/(1,0). Edges come in row-major (u, v)
    order; a clip with more than ``edges_cap`` keeps the first."""
    b, tc, _ = spatial.shape
    dev = spatial.device
    any_edge = (spatial | temporal).reshape(b, -1).any(-1)
    fb = torch.zeros((tc, tc), dtype=torch.bool, device=dev)
    fb[0, 1] = fb[1, 0] = True
    spatial = torch.where(any_edge[:, None, None], spatial, fb[None])

    mask = spatial | temporal
    flat = mask.reshape(b, -1)
    # stable partition: edge positions first
    order = torch.sort((~flat).to(torch.uint8), dim=1, stable=True).indices[:, :edges_cap]
    edge_mask = torch.gather(flat, 1, order)
    u = order // tc
    v = order % tc
    edge_index = torch.stack([u, v], dim=-1) * edge_mask[..., None]
    is_temporal = torch.gather(temporal.reshape(b, -1), 1, order)
    edge_type = (edge_mask & is_temporal).to(torch.int32)
    adj = mask.to(torch.float32)
    return edge_index.to(torch.int32), edge_type, edge_mask, adj
