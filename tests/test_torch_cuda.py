"""Card-only tests: the hand-written CUDA NMS kernel against its plain
PyTorch version on the same CUDA tensors, through all three of its call
contracts (presorted with max_keep, ranked inside the call, grouped with
ranks). Tolerance: exact (keep masks are booleans, ranks integers).
The grouped contract's bfloat16 route likewise, bit for bit against the
plain bfloat16 version (per-operation rounding, the threshold in bfloat16)
on random, tied and near-threshold inputs, ranked in the kernel and past
its 1024 (torch ranks). The bfloat16 detector on the card against the
CPU's bfloat16 detector: base and head features within 2**-6 x max|ref|
(cuDNN and oneDNN sum in other orders before each rounding to bfloat16).
Then the predcls and sgcls paths: a small video served in float32 on the
card against float64 on the CPU (discrete outputs exact), and the sgcls
relabel on the card against its CPU run (bit for bit). Then TEAT-GT: the
masked Laplacian eigendecomposition on the card against float64 on the
CPU (eigenvalues and the projector of each eigenvalue cluster), and a
predcls video served in float32 on the card against float64 on the CPU
with the CPU's eigenvectors injected. Then training: float64 predcls and
sgcls train steps on the card against the CPU's, TEAT-GT's float64 train
steps (predcls, and sgcls and sgdet with the OSPU) and its consistency
losses likewise, TokenGT's random node identifiers and Performer in
float64 on the card against the CPU, and the sgdet train frontend's entry
and its two kernel launches.
Skipped where there is no CUDA card.

This file imports neither JAX nor ``vidsgg``, so it also runs on a machine
without them: ``python -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch_parity_utils import cuda_device  # noqa: F401  (fixture)

from vidsgg_torch.ops import nms as tnms


def _problems(rng, g, n, span=400.0):
    x1y1 = rng.rand(g, n, 2).astype(np.float32) * span
    wh = rng.rand(g, n, 2).astype(np.float32) * 40 + 2
    boxes = np.concatenate([x1y1, x1y1 + wh], -1)
    scores = rng.rand(g, n).astype(np.float32)
    valid = rng.rand(g, n) > 0.25
    valid[0] = False                       # one all-invalid problem
    return boxes, scores, valid


@pytest.mark.cuda
@pytest.mark.parametrize("shape,thresh,max_keep,presorted", [
    ((16, 6000), 0.7, 100, True),          # the RPN call
    ((16 * 36, 100), 0.4, None, False),    # the (frame, class) grid
    ((3, 1), 0.5, None, False),
    ((5, 257), 0.5, None, False),          # not a multiple of the block width
    ((4, 11000), 0.5, 7, False),           # ranked by torch (N > 1024), then scanned
    ((6, 31), 0.5, None, False),           # tile boundaries, ranked in the kernel
    ((6, 32), 0.5, None, False),
    ((6, 33), 0.5, None, False),
    ((6, 64), 0.5, None, False),
    ((6, 65), 0.5, None, False),
    ((3, 1024), 0.5, None, False),
    ((3, 1025), 0.5, None, False),
    ((6, 65), 0.5, None, True),
    ((6, 1025), 0.3, None, True),
    ((5, 200), 0.3, 40, True),             # max_keep reached inside a tile
    ((5, 200), 0.3, 40, False),
])
def test_kernel_matches_plain(cuda_device, shape, thresh, max_keep, presorted):
    rng = np.random.RandomState(0)
    boxes, scores, valid = _problems(rng, *shape)
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        scores = np.take_along_axis(scores, order, 1)
        valid = np.ones(shape, bool)
    b, s, v = (torch.from_numpy(x).to(cuda_device) for x in (boxes, scores, valid))
    before = tnms.NMS_KERNEL.launches
    got = tnms.nms_mask_batched(b, s, v, thresh, max_keep=max_keep, presorted=presorted)
    torch.cuda.synchronize()
    assert tnms.NMS_KERNEL.launches == before + 1
    want = tnms.nms_mask_batched_plain(b, s, v, thresh, max_keep=max_keep,
                                       presorted=presorted)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_identical_boxes_keep_one(cuda_device):
    b = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device=cuda_device).expand(2, 50, 4).contiguous()
    s = torch.linspace(1, 0, 50, device=cuda_device).expand(2, 50)
    v = torch.ones((2, 50), dtype=torch.bool, device=cuda_device)
    got = tnms.nms_mask_batched(b, s, v, 0.5)
    assert got.sum(1).tolist() == [1, 1] and got[:, 0].all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,groups", [(512, 6), (33, 1), (300, 300), (1100, 4)])
def test_grouped_matches_plain(cuda_device, dtype, m, groups):
    """Keep and rank bit-equal; a single group, one group per box, and an
    M past the in-kernel ranking (torch ranks, the kernel scans)."""
    rng = np.random.RandomState(m)
    xy = rng.randint(0, 60, size=(m, 2))
    boxes = np.concatenate([xy, xy + rng.randint(4, 20, size=(m, 2))], 1)
    boxes[:2] = [(0, 0, 9, 9), (0, 0, 9, 5)]       # IoU exactly 0.6
    scores = rng.randint(0, 10, size=m) / 10.0       # ties
    group = rng.randint(0, groups, size=m) if groups < m else np.arange(m)
    group[:2] = 0
    valid = rng.rand(m) > 0.3
    valid[:2] = True
    b, s = (torch.tensor(x, dtype=dtype, device=cuda_device) for x in (boxes, scores))
    g = torch.from_numpy(group).to(cuda_device)
    v = torch.from_numpy(valid).to(cuda_device)
    before = tnms.NMS_KERNEL.launches_by.get("grouped", 0)
    keep, rank = tnms.grouped_nms(b, s, g, v, 0.6)
    torch.cuda.synchronize()
    assert tnms.NMS_KERNEL.launches_by["grouped"] == before + 1
    want_keep, want_rank = tnms.grouped_nms_plain(b, s, g, v, 0.6)
    assert torch.equal(keep, want_keep) and torch.equal(rank, want_rank)
    assert keep[0] and keep[1]
    if groups == m:
        assert torch.equal(keep, v)
    if groups == 1:
        order = torch.argsort(rank)
        ungrouped = tnms.nms_sorted_plain(b[order][None], v[order][None], 0.6)[0]
        assert torch.equal(keep[order], ungrouped)


def _bf16_grouped_case(m, seed):
    """bfloat16 boxes, scores tied on a coarse grid, and partners shifted
    so that their bfloat16 IoU lands near bfloat16(0.6) = 0.6015625."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (m, 2))
    wh = rng.uniform(20, 60, (m, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    for i in range(0, m - 1, 4):
        w = boxes[i, 2] - boxes[i, 0] + 1
        dx = w * 0.4 / 1.6 + rng.uniform(-1.5, 1.5)
        boxes[i + 1] = boxes[i] + np.array([dx, 0, dx, 0])
    scores = np.round(rng.rand(m) * 16) / 16
    group = rng.randint(0, 4, m)
    valid = rng.rand(m) < 0.9
    return boxes, scores, group, valid


@pytest.mark.cuda
@pytest.mark.parametrize("m,seed", [(64, 0), (512, 1), (1024, 2), (1100, 3), (3000, 4)])
def test_grouped_bf16_matches_plain(cuda_device, m, seed):
    """The bfloat16 route: keep and rank bit-equal to the plain bfloat16
    version on the card, below and above MAX_RANKED; IoUs at the rounded
    threshold occur; the launch is counted as a bfloat16 one."""
    boxes, scores, group, valid = _bf16_grouped_case(m, seed)
    b, s = (torch.tensor(x, dtype=torch.bfloat16, device=cuda_device) for x in (boxes, scores))
    g = torch.from_numpy(group).to(cuda_device)
    v = torch.from_numpy(valid).to(cuda_device)
    x1, y1, x2, y2 = b.unbind(-1)
    iw = torch.minimum(x2[:, None], x2) - torch.maximum(x1[:, None], x1) + 1.0
    ih = torch.minimum(y2[:, None], y2) - torch.maximum(y1[:, None], y1) + 1.0
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    iou = inter / (area[:, None] + area - inter)
    assert int((iou == 0.6015625).sum()) > 0
    before = tnms.NMS_KERNEL.launches_by_dtype.get("grouped bfloat16", 0)
    keep, rank = tnms.grouped_nms(b, s, g, v, 0.6)
    torch.cuda.synchronize()
    assert tnms.NMS_KERNEL.launches_by_dtype["grouped bfloat16"] == before + 1
    want_keep, want_rank = tnms.grouped_nms_plain(b, s, g, v, 0.6)
    assert torch.equal(keep, want_keep) and torch.equal(rank, want_rank)
    assert 0 < int(keep.sum()) <= int(v.sum())
    if m >= 512:
        assert int(keep.sum()) < int(v.sum())


@pytest.mark.cuda
def test_bf16_detector_card_matches_cpu(cuda_device):
    """The bfloat16 detector (float32 weights) on the card against the same
    detector on the CPU: base features from the same frames and head
    features from the same pooled input within 2**-6 x max|ref|."""
    from vidsgg_torch.detector import FasterRCNN, RPNConfig

    det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=8),
                     base_blocks=(1, 1, 1), head_blocks=1, device="cpu",
                     generator=torch.Generator().manual_seed(7), dtype=torch.bfloat16)
    card = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=8),
                      base_blocks=(1, 1, 1), head_blocks=1, device=cuda_device,
                      dtype=torch.bfloat16)
    card.load_state_dict(det.state_dict())
    rng = np.random.RandomState(3)
    frames = torch.from_numpy((rng.randn(2, 96, 160, 3) * 40).astype(np.float32))
    pooled = torch.from_numpy(rng.randn(12, 7, 7, 1024).astype(np.float32))
    with torch.no_grad():
        pairs = [(det.base_features(frames), card.base_features(frames.to(cuda_device))),
                 (det.head_to_tail(pooled), card.head_to_tail(pooled.to(cuda_device)))]
    for want, got in pairs:
        assert got.dtype == want.dtype == torch.float32
        tol = 2.0 ** -6 * float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    # presorted without max_keep keeps up to N boxes in shared memory
    n = 1024
    while tnms.smem_bytes(n) <= tnms._SMEM_LIMIT:
        n *= 2
    b = torch.zeros((1, n, 4), device=cuda_device)
    v = torch.ones((1, n), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        tnms.nms_sorted_cuda(b, v, 0.5)
    tnms.nms_sorted_cuda(b, v, 0.5, max_keep=100)   # with max_keep it fits
    with pytest.raises(TypeError):
        tnms.nms_sorted_cuda(b[:, :8].half(), v[:, :8], 0.5)


# ---------------------------------------------------------------------------
# predcls and sgcls serving on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gt_models():
    """A shrunk detector and one-layer TEMPURA per GT mode, float64 on the
    CPU (the reference the card's float32 run is held against); also loads
    cuDNN and cuBLAS on the card, so that their first-use cost falls here
    and not in a test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.nn.functional.conv2d(torch.zeros((1, 3, 8, 8), device="cuda"),
                               torch.zeros((4, 3, 3, 3), device="cuda"))
    torch.zeros((8, 8), device="cuda") @ torch.zeros((8, 8), device="cuda")
    from vidsgg_torch.detector import FasterRCNN, RPNConfig
    from vidsgg_torch.models import Tempura, TempuraConfig

    det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=8),
                     base_blocks=(1, 1, 1), head_blocks=1, device="cpu",
                     generator=torch.Generator().manual_seed(7)).double()
    rels = {}
    for mode in ("predcls", "sgcls"):
        cfg = TempuraConfig.for_mode(mode, obj_head="linear", rel_head="gmm", enc_layers=1,
                                     dec_layers=1, track_layers=1)
        rels[mode] = Tempura(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(8)).double()
    return det, rels


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
def test_gt_video_card_float32_matches_cpu_float64(cuda_device, gt_models, mode):
    """A small GT-box video served in float32 on the card agrees with the
    float64 CPU run: discrete outputs exact, floats at atol
    1e-4 x max(1, max|ref|) (float32 against float64)."""
    import copy

    from vidsgg_torch.data import EntryCapacity
    from vidsgg_torch.detector import GtFrontend
    from vidsgg_torch.serving_setup import gt_video, make_frames
    from vidsgg_torch.train import EvalPipeline, create_serving_state

    det, rels = gt_models
    f, h, w = 6, 160, 256
    cap = EntryCapacity(f, 4 * f, 3 * f)
    frames = make_frames(3, f, h, w, "cpu")
    _, skeleton = gt_video(5, mode, "cpu", cap=cap, num_frames=f, im_scale=w / 480)
    preds = []
    card = (copy.deepcopy(det).to(cuda_device, torch.float32),
            copy.deepcopy(rels[mode]).to(cuda_device, torch.float32))
    for dev, (d, r) in (("cpu", (det, rels[mode])), (cuda_device, card)):
        entry, fmaps = GtFrontend(d)(frames.to(dev), skeleton.to(dev))
        pipe = EvalPipeline(mode, cap, device=dev)
        preds.append(pipe(create_serving_state(r), entry, fmaps, gt_entry=entry))
        assert pipe.last_route == "device"
    want, got = preds
    assert len(want["pair_idx"]) > 0
    for k in ("labels", "im_idx", "pair_idx", "pred_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("spatial_gt", "contacting_gt"):
        assert got[k] == want[k]
    for k in ("boxes", "pred_scores", "attention_distribution", "spatial_distribution",
              "contacting_distribution"):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_sgcls_postprocess_device_card_equals_cpu(cuda_device, seed):
    """The sgcls relabel on the card equals its CPU run bit for bit, on a
    distribution with tied label counts and tied duplicate scores."""
    import dataclasses

    from vidsgg_torch.data import EntryCapacity, build_gt_entry, synthetic_video_annotation
    from vidsgg_torch.models.postprocess_device import sgcls_postprocess_device

    ann = synthetic_video_annotation(num_frames=5, objs_per_frame=4, seed=seed)
    entry = build_gt_entry(ann, EntryCapacity(8, 32, 24), device="cpu")
    rng = np.random.RandomState(seed)
    dist = (np.round(rng.rand(32, 36) * 4) / 40).astype(np.float32)   # ties everywhere
    dist[:, 0] = 0.01
    dist[::5, 0] = 0.9
    dist[[1, 2, 3, 4], [7, 7, 10, 10]] = 0.8        # two labels twice, tied scores
    dist[[6, 7, 8], 20] = 0.7
    dist *= entry.obj_mask.numpy()[:, None]
    d = torch.from_numpy(dist)
    want = sgcls_postprocess_device(entry, d)
    got = sgcls_postprocess_device(entry.to(cuda_device), d.to(cuda_device))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name).cpu(), getattr(want, f.name)
        assert g.dtype == w.dtype and torch.equal(g, w), f.name


# ---------------------------------------------------------------------------
# TEAT-GT on the card
# ---------------------------------------------------------------------------


def _clip_graphs(n=40):
    """Clip-like graphs: isolated nodes, several components, a dense block,
    the (0,1)/(1,0) fallback, and padding."""
    rng = np.random.RandomState(11)
    adj = np.zeros((5, n, n), np.float32)
    valid = [6, 17, 40, 29, 2]
    for b, nv in enumerate(valid):
        a = np.triu(rng.rand(nv, nv) < (0.08, 0.2, 0.35, 0.05, 1.0)[b], 1)
        adj[b, :nv, :nv] = a + a.T
    adj[0, 4:, :] = adj[0, :, 4:] = 0.0          # nodes 4 and 5 isolated
    mask = np.arange(n)[None] < np.array(valid)[:, None]
    return torch.from_numpy(adj), torch.from_numpy(mask)


def _cluster_projectors(val, vec, mask, tol=1e-6):
    """Projectors onto each run of float64 eigenvalues closer than ``tol``
    in each graph's valid spectrum, keyed by (graph, first, last)."""
    out = {}
    for b in range(val.shape[0]):
        nv, i = int(mask[b].sum()), 0
        while i < nv:
            j = i + 1
            while j < nv and float(val[b, j] - val[b, j - 1]) < tol:
                j += 1
            v = vec[b][:, i:j].double()
            out[(b, i, j)] = v @ v.T
            i = j
    return out


@pytest.mark.cuda
def test_teatgt_eigh_on_the_card_matches_cpu_float64(cuda_device):
    """The relation stage's eigendecomposition on the card (float64: see
    ``vidsgg_torch/models/teatgt.py``) against float64 on the CPU:
    eigenvalues and cluster projectors at atol 1e-8, padding rows zero."""
    from vidsgg_torch.ops import masked_laplacian_eig

    adj, mask = _clip_graphs()
    val64, vec64 = masked_laplacian_eig(adj.double(), mask)
    val, vec = masked_laplacian_eig(adj.double().to(cuda_device), mask.to(cuda_device))
    val, vec = val.cpu(), vec.cpu()
    for b in range(adj.shape[0]):
        nv = int(mask[b].sum())
        assert torch.allclose(val[b, :nv], val64[b, :nv], rtol=0, atol=1e-8)
    want = _cluster_projectors(val64, vec64, mask)
    got = {k: vec[k[0]][:, k[1]:k[2]] @ vec[k[0]][:, k[1]:k[2]].T for k in want}
    assert any(j - i > 1 for (_, i, j) in want)          # repeated eigenvalues present
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=0, atol=1e-8), k
    assert not vec[~mask].any()


@pytest.mark.cuda
def test_teatgt_predcls_card_float32_matches_cpu_float64(cuda_device, gt_models):
    """A small GT-box video through a small TEAT-GT: float32 on the card
    against float64 on the CPU, the CPU's eigenvectors injected into the
    card's run after its adjacency is checked equal: discrete outputs exact,
    floats at atol 1e-4 x max(1, max|ref|)."""
    import copy

    from vidsgg_torch.data import EntryCapacity
    from vidsgg_torch.detector import GtFrontend
    from vidsgg_torch.models import TeatGT, TeatGTConfig
    from vidsgg_torch.models import teatgt as tteatgt
    from vidsgg_torch.models.graph_build import ClipCaps
    from vidsgg_torch.serving_setup import gt_video, make_frames
    from vidsgg_torch.train import EvalPipeline, create_serving_state

    det, _ = gt_models
    f, h, w = 6, 160, 256
    cap = EntryCapacity(f, 4 * f, 3 * f)
    frames = make_frames(3, f, h, w, "cpu")
    _, skeleton = gt_video(5, "predcls", "cpu", cap=cap, num_frames=f, im_scale=w / 480)
    cfg = TeatGTConfig.for_mode("predcls", encoder_layers=2, encoder_attention_heads=4,
                                encoder_embed_dim=32, encoder_ffn_embed_dim=48,
                                caps=ClipCaps(5, 2, 24, 96, 8))
    rel = TeatGT(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).double()
    eig = tteatgt.masked_laplacian_eig
    recorded, preds = [], []

    def record(adj, mask):
        out = eig(adj, mask)
        recorded.append((adj.clone(), out))
        return out

    def replay(adj, mask):
        want_adj, (val, vec) = recorded.pop(0)
        assert torch.equal(adj.cpu(), want_adj)
        return val.to(adj.device), vec.to(adj.device)

    card = (copy.deepcopy(det).to(cuda_device, torch.float32),
            copy.deepcopy(rel).to(cuda_device, torch.float32))
    try:
        for dev, (d, r), fn in (("cpu", (det, rel), record), (cuda_device, card, replay)):
            tteatgt.masked_laplacian_eig = fn
            entry, fmaps = GtFrontend(d)(frames.to(dev), skeleton.to(dev))
            pipe = EvalPipeline("predcls", cap, needs_union=False, device=dev)
            preds.append(pipe(create_serving_state(r), entry, fmaps, gt_entry=entry))
    finally:
        tteatgt.masked_laplacian_eig = eig
    assert not recorded
    want, got = preds
    assert len(want["pair_idx"]) > 0
    for k in ("labels", "im_idx", "pair_idx", "pred_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("boxes", "attention_distribution", "spatial_distribution",
              "contacting_distribution"):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
def test_float64_train_steps_on_the_card_match_cpu(cuda_device, mode):
    """Two train steps of a one-layer TEMPURA (the second with filled
    memory banks; sgcls with the OSPU's train phase, one tracking layer and
    the object memory) in float64 on the card and on the CPU, the CPU's
    dropout masks and GMM noise replayed on the card: every loss, gradient
    norm, bank, parameter and batch-norm statistic within 1e-8 x max(1,
    max|CPU's|)."""
    from vidsgg_torch.serving_setup import train_steps_card_vs_cpu

    assert train_steps_card_vs_cpu(cuda_device, mode=mode) <= 1e-8


@pytest.mark.cuda
def test_teatgt_float64_train_steps_on_the_card_match_cpu(cuda_device):
    """Two TEAT-GT predcls train steps (2 layers at the published width,
    the ctl and both consistency losses) in float64 on the card and on the
    CPU, the CPU's dropout masks and sign flips replayed and its
    eigendecompositions (clip and frame graphs) injected on the card: every
    loss, gradient norm and parameter within 1e-8 x max(1, max|CPU's|); both
    consistency losses nonzero (the reference video's frame graphs differ)."""
    from vidsgg_torch.serving_setup import teatgt_train_steps_card_vs_cpu

    err, losses = teatgt_train_steps_card_vs_cpu(cuda_device)
    assert err <= 1e-8 and all(v > 0 for v in losses.values()), (err, losses)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_teatgt_object_modes_float64_train_steps_on_the_card_match_cpu(cuda_device, mode):
    """Two TEAT-GT sgcls or sgdet train steps (2 layers at the published
    width with the tracking OSPU at its 2376, one tracking layer; the
    train CLI's losses:
    the object loss, the ctl and both consistency losses) in float64 on the
    card and on the CPU, the CPU's draws replayed (the OSPU's masks first)
    and its decompositions injected on the card: every loss, gradient
    norm, parameter and batch-norm statistic within 1e-8 x max(1,
    max|CPU's|)."""
    from vidsgg_torch.serving_setup import teatgt_train_steps_card_vs_cpu

    err, losses = teatgt_train_steps_card_vs_cpu(cuda_device, mode=mode)
    assert err <= 1e-8 and all(v > 0 for v in losses.values()), (err, losses)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(node_id_mode="rand"), dict(node_id_mode="orf"),
                                dict(performer=True)])
def test_random_node_ids_and_performer_on_the_card_match_cpu(cuda_device, kw):
    """TokenGT (d = 32, 2 layers x 4 heads) with ``rand`` or ``orf`` node
    identifiers or the Performer, in float64 on the card and on the CPU:
    the test phase's fixed draws (a CPU generator: the same values on both;
    the orthogonal matrices' QR on each device) and a train-phase forward
    and backward on the CPU's recorded draws and the train step's
    Performer draws (``performer_noise``): outputs and every parameter's
    gradient within 1e-8 x max(1, max|CPU's|)."""
    import copy

    from vidsgg_torch.models.noise import Noise, RecordingNoise
    from vidsgg_torch.models.tokengt import TokenGTEncoder
    from vidsgg_torch.train.steps import performer_noise

    rng = np.random.RandomState(3)
    b, n, e = 3, 9, 20
    node_mask = rng.rand(b, n) > 0.2
    edge_mask = rng.rand(b, e) > 0.3
    inputs = [rng.randn(b, n, 1168) * node_mask[..., None], node_mask,
              rng.randint(0, 5, (b, n)) * node_mask,
              rng.randint(0, n, (b, e, 2)) * edge_mask[..., None],
              rng.randint(0, 2, (b, e)) * edge_mask, edge_mask,
              np.linalg.qr(rng.randn(b, n, n))[0] * node_mask[..., None]]
    model = TokenGTEncoder(embed_dim=32, layers=2, heads=4, ffn_dim=48, lap_node_id_k=6,
                           performer_nb_features=16, **kw).double()
    card_model = copy.deepcopy(model).to(cuda_device)
    recorded = RecordingNoise(Noise.seeded(4, "cpu"))
    outs = []
    for dev, m in (("cpu", model), (cuda_device, card_model)):
        args = [torch.from_numpy(np.asarray(x)).to(dev) for x in inputs]
        with torch.no_grad():
            test = m(*args)
        draws = recorded.replay() if outs else recorded
        train = m(*args, deterministic=False, noise=draws, performer=performer_noise(0, 1000))
        sum((t * (i + 1)).sum() for i, t in enumerate(train)).backward()
        outs.append([t.detach().cpu() for t in (*test, *train)]
                    + [p.grad.cpu() for p in m.parameters()])
    for i, (g, w) in enumerate(zip(outs[1], outs[0], strict=True)):
        assert float((g - w).abs().max()) <= 1e-8 * max(1.0, float(w.abs().max())), i


@pytest.mark.cuda
def test_sgdet_train_entry_card_matches_cpu(cuda_device, monkeypatch):
    """The sgdet train frontend (a tiny detector in float64, two 64x96
    frames, an annotation on the CPU's detections plus GT boxes it missed)
    on the card against the CPU: two NMS kernel launches (the RPN and the
    class grid), each bit-equal to its plain version on the inputs the path
    gave it; the entry's discrete fields equal, its floating fields within
    1e-5 x max(1, max|CPU's|) (both round the head's output to float32)."""
    import copy
    import dataclasses

    from vidsgg_torch.data import EntryCapacity, synthetic_video_annotation
    from vidsgg_torch.detector import FasterRCNN, RPNConfig, SgdetCaps, SgdetFrontend
    from vidsgg_torch.detector import sgdet

    f, h, w = 2, 64, 96
    det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=16),
                     base_blocks=(1, 1, 1), head_blocks=1, device="cpu",
                     generator=torch.Generator().manual_seed(3)).double()
    with torch.no_grad():
        det.RCNN_cls_score.weight.mul_(40.0)
    caps, cap = SgdetCaps(8, 16), EntryCapacity(4, 32, 16)
    frames = torch.from_numpy(np.random.RandomState(4).rand(f, h, w, 3) * 80.0 - 40.0)
    hw = (float(h), float(w))
    cpu = SgdetFrontend(det, caps, cap, device="cpu")
    with torch.no_grad():
        dets = cpu.detect(frames.double(), torch.tensor(hw), 1.0)
    ann = synthetic_video_annotation(num_frames=f, objs_per_frame=2, seed=5, image_wh=(w, h))
    for i, frame in enumerate(ann):
        boxes = dets["boxes"][i][dets["mask"][i]].numpy()
        assert len(boxes) >= 2
        frame[0]["person_bbox"] = boxes[0][None].astype(np.float32)
        frame[1]["bbox"] = boxes[1].astype(np.float32)
    want, _ = cpu(frames, hw, 1.0, gt_annotation=ann, is_train=True)

    calls = []
    kernel_fn = sgdet.batched_class_nms

    def recording(fn, plain):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            calls.append((out.clone(), plain(*args, **kw)))
            return out
        return wrapped

    from vidsgg_torch.detector import rpn
    monkeypatch.setattr(rpn, "nms_mask_batched",
                        recording(rpn.nms_mask_batched, tnms.nms_mask_batched_plain))
    monkeypatch.setattr(sgdet, "batched_class_nms",
                        recording(kernel_fn, tnms.nms_mask_batched_plain))
    card = SgdetFrontend(copy.deepcopy(det).to(cuda_device), caps, cap, device=cuda_device)
    before = tnms.NMS_KERNEL.launches
    got, _ = card(frames.to(cuda_device), hw, 1.0, gt_annotation=ann, is_train=True)
    torch.cuda.synchronize()
    assert tnms.NMS_KERNEL.launches == before + 2 and len(calls) == 2
    for out, plain in calls:
        assert torch.equal(out, plain)
    assert not got.features.is_inference()
    for field in dataclasses.fields(want):
        g, wt = getattr(got, field.name).cpu(), getattr(want, field.name)
        if wt.is_floating_point() and field.name not in ("spatial_gt", "contacting_gt"):
            scale = max(1.0, float(wt.abs().max())) if wt.numel() else 1.0
            assert float((g - wt).abs().max() if wt.numel() else 0.0) <= 1e-5 * scale, field.name
        else:
            assert torch.equal(g, wt), field.name
