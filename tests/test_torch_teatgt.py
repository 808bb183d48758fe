"""TEAT-GT's modules in the port against ``vidsgg``: the masked Laplacian
eigendecomposition, the token layout, the clip edge masks and edge list,
``GlobalAttentionPooling``, ``TokenGTEncoder``, ``TeatGT.relation_forward``
in all three modes, the converter and the parameter-tree audit. Tiny
widths (TokenGT d=32, 2 layers, 4 heads), full token width (1168).

Tolerances, float64 on both sides (JAX in its x64 context):
* eigenvalues at atol 1e-8, and the projector onto each eigenvalue cluster
  (eigenvalues closer than 1e-6 form one) at atol 1e-8: eigenvectors
  themselves are unique only up to sign and the basis of a repeated
  eigenvalue's eigenspace, which each LAPACK picks its own way;
* the layout, edge masks, edge list and adjacency: exact;
* pooling, TokenGT and ``relation_forward``: atol 1e-8 x max(1, max|ref|),
  TokenGT fed the same eigenvectors, and ``relation_forward`` given
  ``vidsgg``'s eigendecomposition of an adjacency that must equal
  ``vidsgg``'s exactly (``EigBridge``);
* the converter round trip: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from teatgt_parity_utils import EigBridge
from torch_parity_utils import assert_trees_equal, entry_to_torch, random_tree, to_np

from vidsgg.data import build_gt_entry as jax_build_gt_entry
from vidsgg.data import synthetic_video_annotation as jax_annotation
from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.models import graph_build as jgb
from vidsgg.models.convert_teatgt import (
    convert_teatgt_state_dict,
    expected_teatgt_shapes,
    validate_converted_teatgt,
)
from vidsgg.models.graph_transformer import GlobalAttentionPooling as JPooling
from vidsgg.models.teatgt import TeatGT as JTeatGT
from vidsgg.models.teatgt import TeatGTConfig as JConfig
from vidsgg.models.tokengt import TokenGTEncoder as JTokenGT
from vidsgg.ops import masked_laplacian_eig as jax_eig
from vidsgg_torch.convert import teatgt_from_jax
from vidsgg_torch.models import graph_build as tgb
from vidsgg_torch.models.graph_transformer import GlobalAttentionPooling
from vidsgg_torch.models.teatgt import TeatGT, TeatGTConfig
from vidsgg_torch.models.tokengt import TokenGTEncoder
from vidsgg_torch.ops import masked_laplacian_eig

F = 8
CAP = JCap(max_frames=F, max_objs=32, max_pairs=24)
# roomy, and tight: 12 tokens a clip (a 5-frame clip holds 20), 16 edges,
# 3 tokens a frame (a frame holds 4)
CAPS = {"roomy": jgb.ClipCaps(5, 2, 24, 128, 8), "tight": jgb.ClipCaps(5, 2, 12, 16, 3)}
TINY = dict(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
            encoder_ffn_embed_dim=48)


def _close(got, want, name, rel=1e-8):
    want = np.asarray(want)
    got = to_np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max(initial=0))),
                               err_msg=name)


# ---------------------------------------------------------------------------
# masked_laplacian_eig
# ---------------------------------------------------------------------------


def _graph(case):
    """(adj [B, N, N] float64, mask [B, N])."""
    rng = np.random.RandomState(3)
    n = 12
    adj = np.zeros((1, n, n))
    mask = np.zeros((1, n), bool)
    if case == "path_isolated_padding":      # path 0-1-2-3, isolated 4 and 5
        for u in range(3):
            adj[0, u, u + 1] = adj[0, u + 1, u] = 1.0
        mask[0, :6] = True
    elif case == "components":               # a triangle, a pair, a star, padding
        for u, v in ((0, 1), (1, 2), (0, 2), (3, 4), (5, 6), (5, 7), (5, 8)):
            adj[0, u, v] = adj[0, v, u] = 1.0
        mask[0, :10] = True
    elif case == "empty":                    # no edges: L = I
        mask[0, :7] = True
    elif case == "directed_weighted":        # in-degrees, not symmetric
        a = (rng.rand(n, n) < 0.3) * rng.rand(n, n)
        np.fill_diagonal(a, 0.0)
        adj[0] = a
        mask[0, :9] = True
    elif case == "batched":                  # random graphs with fallback-like clips
        adj = np.zeros((4, n, n))
        mask = np.zeros((4, n), bool)
        for b in range(4):
            a = np.triu(rng.rand(n, n) < 0.2, 1).astype(np.float64)
            adj[b] = a + a.T
            mask[b, : 4 + 2 * b] = True
        adj[3] = 0.0
        adj[3, 0, 1] = adj[3, 1, 0] = 1.0
    return adj, mask


def _cluster_projectors(val, vec, mask, tol=1e-6):
    """{(b, first index): projector} over runs of eigenvalues within tol."""
    out = {}
    for b in range(val.shape[0]):
        i = 0
        while i < val.shape[1]:
            j = i + 1
            while j < val.shape[1] and val[b, j] - val[b, j - 1] < tol:
                j += 1
            v = vec[b][:, i:j]
            out[(b, i, j)] = v @ v.T
            i = j
    return out


@pytest.mark.parametrize("case", ["path_isolated_padding", "components", "empty",
                                  "directed_weighted", "batched"])
def test_masked_laplacian_eig(case):
    adj, mask = _graph(case)
    with jax.enable_x64(True):
        jval, jvec = (np.asarray(x) for x in jax_eig(jnp.asarray(adj), jnp.asarray(mask)))
    val, vec = masked_laplacian_eig(torch.from_numpy(adj), torch.from_numpy(mask))
    val, vec = to_np(val), to_np(vec)
    assert val.dtype == np.float64
    np.testing.assert_allclose(val, jval, rtol=0, atol=1e-8)
    got, want = _cluster_projectors(val, vec, mask), _cluster_projectors(jval, jvec, mask)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-8, err_msg=str(key))
    assert not vec[~mask].any()          # padding rows zeroed
    if case in ("path_isolated_padding", "components", "empty"):
        # repeated eigenvalues are present: isolated nodes (1), components (0)
        assert any(j - i > 1 for (_, i, j) in want if i < mask.sum())


# ---------------------------------------------------------------------------
# layout, edges
# ---------------------------------------------------------------------------


def _entry(seed, dtype=np.float64, drop_frame=None, objs=3):
    """A GT-box entry with features that repeat per object slot (plus
    noise), so that adjacent frames share similar tokens (temporal edges),
    on a 480x270 video (spatial edges)."""
    ann = jax_annotation(num_frames=F - 1, objs_per_frame=objs, seed=seed, stable=True)
    e = jax_build_gt_entry(ann, CAP)
    rng = np.random.RandomState(seed)
    n = CAP.max_objs
    obj_mask = np.asarray(e.obj_mask)
    slot = np.arange(n) % (objs + 1)
    base = rng.randn(objs + 1, 2048)
    features = (base[slot] + 0.3 * rng.randn(n, 2048)) * obj_mask[:, None]
    pair_mask = np.asarray(e.pair_mask).copy()
    if drop_frame is not None:               # a frame without pairs: no person token
        pair_mask &= np.asarray(e.im_idx) != drop_frame
    fields = dict(features=features, boxes=np.asarray(e.boxes),
                  pred_labels=np.asarray(e.labels), pair_mask=pair_mask,
                  video_size=np.array([480.0, 270.0]),
                  distribution=np.asarray(e.distribution))
    return e.replace(**{k: (v.astype(dtype) if v.dtype.kind == "f" else v)
                        for k, v in fields.items()})


def _layouts(entry, caps_name):
    jcaps = CAPS[caps_name]
    tcaps = tgb.ClipCaps(**dataclasses.asdict(jcaps))
    want = jgb.build_token_layout(entry, jcaps)
    got = tgb.build_token_layout(entry_to_torch(entry), tcaps)
    return got, want


@pytest.mark.parametrize("caps_name,drop_frame", [("roomy", None), ("tight", None),
                                                  ("tight", 2)])
def test_token_layout_exact(caps_name, drop_frame):
    with jax.enable_x64(True):
        got, want = _layouts(_entry(1, drop_frame=drop_frame), caps_name)
    for f in dataclasses.fields(tgb.TokenLayout):
        g, w = to_np(getattr(got, f.name)), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    if caps_name == "tight":   # clips and frames overflow: tokens are dropped
        assert want.clip_mask.sum() < want.token_valid.sum()
        assert want.frame_mask.sum() < want.token_valid.sum()


@pytest.mark.parametrize("caps_name,per_clip_thr", [("roomy", False), ("tight", False),
                                                    ("roomy", True)])
def test_edges_exact(caps_name, per_clip_thr):
    rng = np.random.RandomState(4)
    jcaps = CAPS[caps_name]
    with jax.enable_x64(True):
        entry = _entry(2)
        lay = jgb.build_token_layout(entry, jcaps)
        ct, cm = np.asarray(lay.clip_tokens), np.asarray(lay.clip_mask)
        feats = np.asarray(entry.features)[np.asarray(lay.token_box)][ct] @ rng.randn(2048, 16)
        frames = np.where(cm, np.asarray(lay.token_frame)[ct]
                          - (np.arange(jcaps.n_clips) * jcaps.clip_size)[:, None], 0)
        centers = np.asarray(lay.token_center)[ct]
        thr = np.array([90.0, 60.0]) if per_clip_thr else np.float64(80.0)
        # a third clip with no edge (one frame, centers 1000 apart): the
        # fallback edge
        frames = np.concatenate([frames, np.zeros_like(frames[:1])])
        centers = np.concatenate([centers, np.zeros_like(centers[:1])
                                  + 1000.0 * np.arange(centers.shape[1])[None, :, None]])
        feats = np.concatenate([feats, feats[:1]])
        cm = np.concatenate([cm, cm[:1]])
        if per_clip_thr:
            thr = np.concatenate([thr, [1.0]])
        inputs = (frames, centers, feats * cm[..., None], cm, thr)
        want_sp, want_te = jgb.clip_edge_masks(*(jnp.asarray(x) for x in inputs))
        want = jgb.masks_to_edge_list(want_sp, want_te, jcaps.edges_per_clip)
        want = [np.asarray(x) for x in (want_sp, want_te) + tuple(want)]
    got_sp, got_te = tgb.clip_edge_masks(*(torch.from_numpy(np.asarray(x)) for x in inputs))
    got = [to_np(x) for x in (got_sp, got_te) + tuple(
        tgb.masks_to_edge_list(got_sp, got_te, jcaps.edges_per_clip))]
    names = ("spatial", "temporal", "edge_index", "edge_type", "edge_mask", "adj")
    for name, g, w in zip(names, got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    sp, te, _, edge_type, edge_mask, _ = want
    assert sp.any() and te.any() and (edge_type == 1).any()
    assert not (sp[-1] | te[-1]).any() and edge_mask[-1].sum() == 2     # fallback (0,1)/(1,0)
    if caps_name == "tight":
        assert ((sp | te).reshape(len(sp), -1).sum(1) > jcaps.edges_per_clip).any()  # truncated


# ---------------------------------------------------------------------------
# pooling, TokenGT
# ---------------------------------------------------------------------------


def test_global_attention_pooling():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 16)
    mask = rng.rand(3, 7) > 0.3
    mask[2] = False                          # an empty clip pools to zero
    with jax.enable_x64(True):
        pool = JPooling()
        variables = random_tree(jax.eval_shape(pool.init, jax.random.PRNGKey(0), x, mask),
                                np.random.default_rng(6), np.float64)
        want = np.asarray(pool.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    gate = torch.nn.Linear(16, 1).double()
    g = variables["params"]["gate_nn"]
    with torch.no_grad():
        gate.weight.copy_(torch.from_numpy(np.asarray(g["kernel"]).T))
        gate.bias.copy_(torch.from_numpy(np.asarray(g["bias"])))
        got = GlobalAttentionPooling(gate)(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want, "pooled")
    assert not want[2].any()


def _tokengt_inputs(k_nodes=9, k_edges=20, b=3, atoms=1168):
    rng = np.random.RandomState(7)
    node_mask = rng.rand(b, k_nodes) > 0.2
    edge_mask = rng.rand(b, k_edges) > 0.3
    edge_index = rng.randint(0, k_nodes, (b, k_edges, 2)) * edge_mask[..., None]
    edge_index[:, 0] = [3, 3]                 # a self edge: order id 1
    edge_mask[:, 0] = True
    q, _ = np.linalg.qr(rng.randn(b, k_nodes, k_nodes))
    return (rng.randn(b, k_nodes, atoms) * node_mask[..., None], node_mask,
            rng.randint(0, 5, (b, k_nodes)) * node_mask, edge_index.astype(np.int32),
            rng.randint(0, 2, (b, k_edges)).astype(np.int32) * edge_mask, edge_mask,
            q * node_mask[..., None])


@pytest.mark.parametrize("k", [6, 50])
def test_tokengt_encoder(k):
    """``k`` below and above the node count (eigenvectors truncated, or
    zero-padded)."""
    inputs = _tokengt_inputs()
    kw = dict(num_atoms=1168, num_output=26, embed_dim=32, layers=2, heads=4, ffn_dim=48,
              lap_node_id_k=k)
    with jax.enable_x64(True):
        jm = JTokenGT(lap_eig_dropout=0.0, **kw)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
        variables = random_tree(shapes, np.random.default_rng(8), np.float64)
        want = [np.asarray(x) for x in jm.apply(variables, *(jnp.asarray(x) for x in inputs))]
    # the TokenGT subtree of a TEAT-GT, converted, into a port TokenGTEncoder
    cfg = TeatGTConfig(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
                       encoder_ffn_embed_dim=48, lap_node_id_k=k)
    tree = {"params": {"tokengt": variables["params"], "subj_fc": _dense(2048, 968),
                       "obj_fc": _dense(2048, 968), "node_label_tokenizer": np.zeros((37, 200)),
                       "gap_gru": {"gate_nn": _dense(32, 1)}}}
    sd = {k2[len("TokenGT_encoder."):]: v for k2, v in teatgt_from_jax(tree, cfg).items()
          if k2.startswith("TokenGT_encoder.")}
    port = TokenGTEncoder(layers=2, heads=4, embed_dim=32, ffn_dim=48,
                          lap_node_id_k=k).double()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.asarray(x)) for x in inputs))
    for name, g, w in zip(("logits", "hidden", "graph_rep"), got, want, strict=True):
        _close(g, w, name)


def _dense(i, o):
    return {"kernel": np.zeros((i, o)), "bias": np.zeros(o)}


# ---------------------------------------------------------------------------
# TeatGT
# ---------------------------------------------------------------------------


def _configs(mode, caps_name="tight", **kw):
    kw = dict(TINY, **kw)
    jcaps = CAPS[caps_name]
    return (JConfig.for_mode(mode, caps=jcaps, **kw),
            TeatGTConfig.for_mode(mode, caps=tgb.ClipCaps(**dataclasses.asdict(jcaps)), **kw))


@pytest.fixture(scope="module", params=["predcls", "sgcls", "sgdet"])
def models(request):
    """Seeded ``vidsgg`` variables and the port's model loaded from them.
    sgcls and sgdet without tracking: ``relation_forward`` never reads the
    object classifier, and its 3-layer 2376-wide tracking encoder is held
    in ``test_torch_teatgt_slice.py``."""
    mode = request.param
    jcfg, tcfg = _configs(mode, tracking=False)
    variables = random_tree(expected_teatgt_shapes(jcfg, JEntry.zeros(CAP)),
                            np.random.default_rng(9), np.float64)
    port = TeatGT(tcfg, device="cpu").double()
    port.load_state_dict(teatgt_from_jax(variables, tcfg))
    yield mode, jcfg, variables, port
    del port, variables


def test_converter_round_trip(models):
    mode, jcfg, variables, port = models
    assert hasattr(port, "object_classifier") == (mode != "predcls")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert torch.equal(port.gate_gru_nn.weight, port.gap_gru.gate_nn.weight)
    assert_trees_equal(convert_teatgt_state_dict(sd, jcfg, strict=True), variables)


@pytest.mark.parametrize("drop_frame", [None, 3])
def test_relation_forward(models, drop_frame, monkeypatch):
    mode, jcfg, variables, port = models
    bridge = EigBridge(monkeypatch)
    entry = _entry(10 + (drop_frame or 0), drop_frame=drop_frame)
    with jax.enable_x64(True):
        jout = JTeatGT(jcfg).apply(variables, entry, None, phase="test",
                                   method="relation_forward")
        jout = jax.tree.map(np.asarray, jout)
    with torch.no_grad():
        out = port.relation_forward(entry_to_torch(entry))
    bridge.assert_consumed()
    assert sorted(out) == sorted(jout)
    for k in jout:
        _close(out[k], jout[k], k)
    # the tight caps drop object tokens: their pairs get zero logits
    att = jout["attention_distribution"][np.asarray(entry.pair_mask)]
    assert np.isclose(att, 1.0 / 3).all(axis=1).any()


def test_forward_is_classify_then_relation(models, monkeypatch):
    """``TeatGT.forward`` (the predcls test step): OSPU in sgcls and sgdet,
    then the relation stage on the entry as it is."""
    mode, jcfg, variables, port = models
    EigBridge(monkeypatch)
    entry = _entry(12)
    with jax.enable_x64(True):
        jout = jax.tree.map(np.asarray, JTeatGT(jcfg).apply(variables, entry, phase="test"))
    with torch.no_grad():
        out = port(entry_to_torch(entry))
    assert sorted(out) == sorted(jout)
    for k in jout:
        _close(out[k], jout[k], k)


@pytest.mark.parametrize("mode", ["predcls", "sgcls", "sgdet"])
def test_state_dict_passes_the_audit(mode):
    """The port's parameter tree at the published geometry of ``mode``
    (predcls without an object classifier; sgcls and sgdet with the
    tracking OSPU, its pe table 400 or 600 long) passes ``vidsgg``'s strict
    converter and its exact-coverage audit."""
    jcfg, tcfg = _configs(mode)
    assert tcfg.tracking == (mode != "predcls")
    port = TeatGT(tcfg, device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    converted = convert_teatgt_state_dict(sd, jcfg, strict=True)
    validate_converted_teatgt(converted, expected_teatgt_shapes(jcfg, JEntry.zeros(CAP)))
    if mode != "predcls":
        assert sd["object_classifier.positional_encoder.pe"].shape == (
            1, 600 if mode == "sgdet" else 400, 2376)


@pytest.mark.parametrize("kw", [dict(node_id_mode="rand"), dict(node_id_mode="orf"),
                                dict(performer=True)])
def test_random_draws_are_refused(kw):
    with pytest.raises(NotImplementedError, match="item 6c"):
        TeatGT(TeatGTConfig.for_mode("predcls", **TINY, **kw), device="cpu")
