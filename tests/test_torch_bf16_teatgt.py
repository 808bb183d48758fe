"""bfloat16 serving of TEAT-GT: ``EvalPipeline(needs_union=False,
compute_dtype=torch.bfloat16)`` against ``vidsgg``'s, stage by stage, in
sgcls (GT-box entry) and sgdet (an entry through ``vidsgg``'s float32
``SgdetFrontend``, shrunk ResNet), at tiny encoder width (d=32, 2 layers,
4 heads) with the OSPU at full width, float32 weights carried across.

``vidsgg``'s bfloat16 run is recorded where TEAT-GT builds its clip graphs:
the inputs and outputs of ``clip_edge_masks`` and ``masks_to_edge_list``
(bfloat16 tokens, centres and threshold) and the eigendecomposition. The
whole pipelines cannot be held to each other: their bfloat16 tokens differ
by an ulp here and there (the products sum in another order), and a cosine
at the 0.75 threshold then adds or drops an edge. So:

* the spatial threshold from the bfloat16 video size, and the graph (edge
  masks, edge list, adjacency) from ``vidsgg``'s bfloat16 tokens: exact;
* TokenGT and the heads of the bfloat16 model on ``vidsgg``'s tokens,
  edges and eigenvectors: atol 2**-6 x max(1, max|ref|) (see
  ``test_torch_bf16_serving.py``), both in float32 past the Laplacian
  identifiers (``vidsgg``'s float32 eigenvectors promote them);
* the port's bfloat16 pipeline against its float32 one on both routes,
  held to ``vidsgg``'s bar for bfloat16 serving: label agreement > 0.9,
  distributions within atol 0.08.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import entry_to_torch, random_tree, to_np

import vidsgg.models.teatgt as jteatgt
import vidsgg.train.eval_pipeline as jep
import vidsgg_torch.models.graph_build as tgraph
from vidsgg.data import build_gt_entry as jax_build_gt_entry
from vidsgg.data import synthetic_video_annotation as jax_annotation
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.detector.sgdet import SgdetCaps as JCaps
from vidsgg.detector.sgdet import SgdetFrontend as JFrontend
from vidsgg.models.convert_teatgt import expected_teatgt_shapes
from vidsgg.models.graph_build import ClipCaps as JClipCaps
from vidsgg.models.teatgt import TeatGT as JTeatGT
from vidsgg.models.teatgt import TeatGTConfig as JConfig
from vidsgg.train.state import TrainState
from vidsgg_torch.convert import teatgt_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.models.graph_build import ClipCaps
from vidsgg_torch.models.teatgt import TeatGT, TeatGTConfig, spatial_threshold
from vidsgg_torch.train import EvalPipeline, create_serving_state
from vidsgg_torch.train.state import cast_state_for_serving

BF16_ATOL = 2.0 ** -6
TINY = dict(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
            encoder_ffn_embed_dim=48)
GT_CAP, F = (8, 32, 24), 6
DF, DH, DW, DETS = 4, 160, 256, 8
SGDET_CAP = (DF, DF * DETS, 48)
CLIPS = {"sgcls": (5, 2, 24, 128, 8), "sgdet": (5, 1, 24, 200, 8)}


def _gt_entry(seed):
    ann = jax_annotation(num_frames=F, objs_per_frame=3, seed=seed, stable=True)
    e = jax_build_gt_entry(ann, JCap(*GT_CAP))
    rng = np.random.RandomState(seed)
    n = GT_CAP[1]
    om = np.asarray(e.obj_mask)
    feats = (rng.randn(4, 2048)[np.arange(n) % 4] + 0.3 * rng.randn(n, 2048)) * om[:, None]
    logits = rng.randn(n, 36)
    logits[np.arange(n), np.clip(np.asarray(e.labels) - 1, 0, 35)] += 4.0
    dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True) * om[:, None]
    e = e.replace(features=feats.astype(np.float32), distribution=dist.astype(np.float32),
                  pred_labels=np.asarray(e.labels),
                  video_size=np.array([480.0, 270.0], np.float32))
    return jax.tree.map(np.asarray, e)


def _sgdet_entry():
    rpn = dict(pre_nms_top_n=600, post_nms_top_n=16)
    jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1)
    shapes = jax.eval_shape(
        lambda r: jdet.init(r, jnp.zeros((1, 64, 64, 3)), jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    det_vars = random_tree(shapes, np.random.default_rng(10), np.float32)
    det_vars["params"]["cls_score"]["kernel"] *= 8.0
    frames = (np.random.RandomState(12).randn(DF, DH, DW, 3) * 40.0).astype(np.float32)
    entry, _ = JFrontend(jdet, det_vars, JCaps(dets_per_frame=DETS), JCap(*SGDET_CAP))(
        jnp.asarray(frames), jnp.asarray((float(DH), float(DW))), 1.0,
        video_size=(float(DW), float(DH)))
    return jax.tree.map(np.asarray, entry)


class GraphRecorder:
    """Records, inside ``vidsgg``'s jitted stages, each clip graph's
    ``clip_edge_masks`` and ``masks_to_edge_list`` inputs and outputs and
    its eigendecomposition (as ``teatgt_parity_utils.EigBridge`` does)."""

    def __init__(self, monkeypatch):
        self.calls = []
        edges, to_list, eig = (jteatgt.clip_edge_masks, jteatgt.masks_to_edge_list,
                               jteatgt.masked_laplacian_eig)

        def keep(name):
            def fn(*arrays):
                self.calls.append((name, tuple(np.array(a) for a in arrays)))
            return fn

        def rec_edges(frames, centers, feats, mask, thr, sim_thr):
            out = edges(frames, centers, feats, mask, thr, sim_thr)
            jax.debug.callback(keep("edges"), frames, centers, feats, mask, thr, *out)
            return out

        def rec_list(spatial, temporal, cap):
            out = to_list(spatial, temporal, cap)
            jax.debug.callback(keep("list"), *out)
            return out

        def rec_eig(adj, mask):
            out = eig(adj, mask)
            jax.debug.callback(keep("eig"), *out)
            return out

        monkeypatch.setattr(jteatgt, "clip_edge_masks", rec_edges)
        monkeypatch.setattr(jteatgt, "masks_to_edge_list", rec_list)
        monkeypatch.setattr(jteatgt, "masked_laplacian_eig", rec_eig)
        for name, fn, static in (
            ("relation_stage_no_union", jep._relation_stage_no_union, ()),
            ("sgcls_fused_stage", jep._sgcls_fused, (3,)),
            ("sgdet_fused_stage", jep._sgdet_fused, (3, 4)),
        ):
            monkeypatch.setattr(jep, name, jax.jit(fn, static_argnums=static))

    def graphs(self):
        """[(edges inputs + outputs, edge list, eigendecomposition)] per call."""
        jax.effects_barrier()
        by = {k: [a for n, a in self.calls if n == k] for k in ("edges", "list", "eig")}
        assert len(by["edges"]) == len(by["list"]) == len(by["eig"]) > 0
        return list(zip(by["edges"], by["list"], by["eig"]))


def _t(a):
    """A recorded array as a torch tensor of its own type (bfloat16 too)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a)


@pytest.fixture(scope="module", params=["sgcls", "sgdet"])
def runs(request):
    """``vidsgg``'s bfloat16 pipeline (recorded) and the port's bfloat16
    and float32 pipelines, on both routes, with the same weights."""
    mode = request.param
    mp = pytest.MonkeyPatch()
    clips = CLIPS[mode]
    jcfg = JConfig.for_mode(mode, caps=JClipCaps(*clips), **TINY)
    tcfg = TeatGTConfig.for_mode(mode, caps=ClipCaps(*clips), **TINY)
    variables = random_tree(expected_teatgt_shapes(jcfg, JEntry.zeros(JCap(*GT_CAP))),
                            np.random.default_rng(30), np.float32)
    port = TeatGT(tcfg, device="cpu")
    port.load_state_dict(teatgt_from_jax(variables, tcfg))
    jentry, cap = (_sgdet_entry(), SGDET_CAP) if mode == "sgdet" else (_gt_entry(20), GT_CAP)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}), opt_state=None,
        rel_memory=jnp.zeros((26, 1936)), obj_memory=jnp.zeros((36, 1024)),
        mem_active=jnp.asarray(False), apply_fn=JTeatGT(jcfg).apply, tx=None)
    try:
        recorder = GraphRecorder(mp)
        jje = jax.tree.map(jnp.asarray, jentry)
        JEvalPipeline = jep.EvalPipeline
        JEvalPipeline(mode, JCap(*cap), needs_union=False, compute_dtype=jnp.bfloat16)(
            state, jje, None, gt_entry=jje)
        graphs = recorder.graphs()
    finally:
        mp.undo()
    entry = entry_to_torch(jentry)
    preds = {}
    for dp in (True, False):
        for dtype in (torch.bfloat16, None):
            pipe = EvalPipeline(mode, EntryCapacity(*cap), needs_union=False,
                                device_postprocess=dp, device="cpu", compute_dtype=dtype)
            preds[dp, dtype] = pipe(create_serving_state(port), entry, None, gt_entry=entry)
            assert pipe.last_route == ("device" if dp else "host")
    yield dict(mode=mode, jcfg=jcfg, variables=variables, port=port, jentry=jentry,
               graphs=graphs, preds=preds, caps=clips)


def test_bf16_graph_on_vidsgg_tokens(runs):
    """The threshold, edge masks, edge list and adjacency from ``vidsgg``'s
    bfloat16 tokens, centres and video size: exact."""
    video_size = torch.from_numpy(np.asarray(runs["jentry"].video_size)).bfloat16()
    for (frames, centers, feats, mask, thr, spatial, temporal), edge_list, _ in runs["graphs"]:
        assert feats.dtype.name == centers.dtype.name == thr.dtype.name == "bfloat16"
        got_thr = spatial_threshold(video_size, 0.5)
        assert got_thr.dtype == torch.bfloat16
        np.testing.assert_array_equal(to_np(got_thr.float()), np.asarray(thr, np.float32))
        got = tgraph.clip_edge_masks(_t(frames), _t(centers), _t(feats), _t(mask), got_thr,
                                     0.75)
        np.testing.assert_array_equal(to_np(got[0]), spatial)
        np.testing.assert_array_equal(to_np(got[1]), temporal)
        assert spatial.any() and temporal.any()
        got_list = tgraph.masks_to_edge_list(got[0], got[1], runs["caps"][3])
        for g, w in zip(got_list, edge_list, strict=True):
            np.testing.assert_array_equal(to_np(g), w)


def test_bf16_tokengt_on_vidsgg_inputs(runs):
    """TokenGT + heads of the bfloat16 model on ``vidsgg``'s recorded clip
    graphs: within bfloat16 tolerance of ``vidsgg``'s TokenGT."""
    vb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), runs["variables"])
    model = cast_state_for_serving(create_serving_state(runs["port"]), torch.bfloat16).model
    tokengt = jax.jit(lambda v, *a: JTeatGT(runs["jcfg"]).apply(
        v, *a, method=lambda m, *x: m.tokengt(*x, True)))
    for (frames, _, feats, mask, *_), (edge_index, edge_type, edge_mask, _), (_, vec) in \
            runs["graphs"]:
        args = (feats, mask, frames, edge_index, edge_type, edge_mask, vec)
        want = [np.asarray(x, np.float64) for x in tokengt(vb, *args)]
        with torch.no_grad():
            got = model.TokenGT_encoder(*[_t(a) for a in args])
        for name, g, w in zip(("logits", "hidden", "graph"), got, want, strict=True):
            np.testing.assert_allclose(to_np(g.double()), w, rtol=0,
                                       atol=BF16_ATOL * max(1.0, np.abs(w).max()),
                                       err_msg=name)


@pytest.mark.parametrize("device_postprocess", [True, False])
def test_bf16_pipeline_against_float32(runs, device_postprocess):
    got = dict(runs["preds"][device_postprocess, torch.bfloat16])
    want = runs["preds"][device_postprocess, None]
    if device_postprocess:
        assert got.pop("bf16_fields") == ("boxes", "scores", "pred_scores")
    assert "bf16_fields" not in got
    assert len(want["pair_idx"]) > 0
    assert got["pred_labels"].shape == want["pred_labels"].shape
    assert np.mean(got["pred_labels"] == want["pred_labels"]) > 0.9
    for k in ("attention_distribution", "spatial_distribution", "contacting_distribution"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.08, err_msg=k)
