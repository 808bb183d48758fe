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
from teatgt_parity_utils import DrawBridge, EigBridge, JaxFixedDraws
from torch_parity_utils import assert_trees_equal, entry_to_torch, random_tree, to_np
from train_parity_utils import SharedNoise

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
from vidsgg.models.graph_transformer import GraphTransformer as JGraphTransformer
from vidsgg.models.teatgt import TeatGT as JTeatGT
from vidsgg.models.teatgt import TeatGTConfig as JConfig
from vidsgg.models.tokengt import TokenGTEncoder as JTokenGT
from vidsgg.ops import masked_laplacian_eig as jax_eig
import vidsgg_torch.models.tokengt as ttokengt
from vidsgg_torch.convert import regularizer_from_jax, teatgt_from_jax
from vidsgg_torch.models import graph_build as tgb
from vidsgg_torch.models.graph_transformer import GlobalAttentionPooling, GraphTransformer
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


@pytest.mark.parametrize("dim", [10, 32])
def test_graph_transformer(dim):
    """The regularizer's encoder (the structural stream's k = 10, the
    semantic stream's d) against ``vidsgg``'s in float64, forward and
    backward (a seeded cotangent: the gradients of the nodes, the edges and
    every parameter): edge-augmented attention over graphs with edges and
    masked rows (one graph empty), gated residuals, the tanh-GELU
    feed-forward, padding zeroed; ``vidsgg``'s tree and gradients carried
    across as ``teatgt_from_jax`` carries them."""
    rng = np.random.RandomState(8)
    b, n = 4, 8
    nodes = rng.randn(b, n, dim)
    mask = rng.rand(b, n) > 0.3
    mask[3] = False                          # an empty frame
    edges = ((rng.rand(b, n, n, 1) > 0.5) * mask[:, :, None, None]
             * mask[:, None, :, None]).astype(np.float64)
    cot = rng.randn(b, n, dim)
    with jax.enable_x64(True):
        gt = JGraphTransformer(dim=dim, max_nodes=n)
        variables = random_tree(jax.eval_shape(gt.init, jax.random.PRNGKey(0), nodes, edges,
                                               mask), np.random.default_rng(9), np.float64)
        want, vjp = jax.vjp(lambda p, x, e: gt.apply({"params": p}, x, e, jnp.asarray(mask)),
                            variables["params"], jnp.asarray(nodes), jnp.asarray(edges))
        grads = [jax.tree.map(np.asarray, g) for g in vjp(jnp.asarray(cot))]
    port = GraphTransformer(dim, max_nodes=n).double()

    def strip(sd):
        return {k[len("gat."):]: v for k, v in sd.items()}

    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          strip(regularizer_from_jax({"gat": variables["params"]})).items()})
    x, e = torch.from_numpy(nodes).requires_grad_(), torch.from_numpy(edges).requires_grad_()
    got = port(x, e, torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    _close(got.detach(), want, "graph transformer")
    assert not np.asarray(want)[3].any() and np.abs(want).max() > 0
    _close(x.grad, grads[1], "d nodes")
    _close(e.grad, grads[2], "d edges")
    want_grads = strip(regularizer_from_jax({"gat": grads[0]}))
    assert sorted(want_grads) == sorted(n for n, _ in port.named_parameters())
    for name, param in port.named_parameters():
        _close(param.grad, want_grads[name], f"d {name}")


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
    port = TokenGTEncoder(layers=2, heads=4, embed_dim=32, ffn_dim=48,
                          lap_node_id_k=k).double()
    port.load_state_dict(_tokengt_state_dict(variables["params"], k))
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.asarray(x)) for x in inputs))
    for name, g, w in zip(("logits", "hidden", "graph_rep"), got, want, strict=True):
        _close(g, w, name)


def test_tokengt_encoder_train_phase(monkeypatch):
    """TokenGT's train phase (eig dropout 0.2, the Laplacian sign flips, the
    token-sequence dropout and four dropouts a layer) under ``vidsgg``'s
    draws, recorded inside its forward and replayed in the port's
    (``SharedNoise``): the outputs and the gradients of the node features
    and of every parameter (a seeded cotangent), float64."""
    inputs = _tokengt_inputs()
    rng = np.random.RandomState(11)
    kw = dict(num_atoms=1168, num_output=26, embed_dim=32, layers=2, heads=4, ffn_dim=48,
              lap_node_id_k=50)
    with jax.enable_x64(True):
        jm = JTokenGT(**kw)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
        variables = random_tree(shapes, np.random.default_rng(8), np.float64)
        noise = SharedNoise(monkeypatch, heads=(), rows=set())
        rest = [jnp.asarray(x) for x in inputs[1:]]
        b, n = inputs[1].shape
        cots = [rng.randn(b, n, 26), rng.randn(b, n, 32), rng.randn(b, 32)]

        @jax.jit
        def forward_backward(p, x, cot):
            out, vjp = jax.vjp(lambda p, x: jm.apply({"params": p}, x, *rest, False,
                                                     rngs={"dropout": jax.random.PRNGKey(4)}),
                               p, x)
            return out, vjp(cot)

        want, grads = forward_backward(variables["params"], jnp.asarray(inputs[0]),
                                       tuple(jnp.asarray(c) for c in cots))
        grads = [jax.tree.map(np.asarray, g) for g in grads]
    jax.effects_barrier()
    replay = noise.replay()
    assert len(replay.masks) == 2 + 4 * 2 and len(replay.uniforms) == 1
    port = TokenGTEncoder(layers=2, heads=4, embed_dim=32, ffn_dim=48, lap_node_id_k=50).double()
    port.load_state_dict(_tokengt_state_dict(variables["params"], 50))
    x = torch.from_numpy(inputs[0]).requires_grad_()
    got = port(x, *(torch.from_numpy(np.asarray(v)) for v in inputs[1:]), deterministic=False,
               noise=replay)
    assert replay.exhausted()
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, g, w in zip(("logits", "hidden", "graph_rep"), got, want, strict=True):
        _close(g.detach(), w, name)
    _close(x.grad, grads[1], "d node_data")
    want_grads = _tokengt_state_dict(grads[0], 50)
    for name, param in port.named_parameters():
        _close(param.grad, want_grads[name], f"d {name}")


def _dense(i, o):
    return {"kernel": np.zeros((i, o)), "bias": np.zeros(o)}


def _tokengt_state_dict(tree, k):
    """A ``vidsgg`` TokenGT subtree (parameters or their gradients) as the
    TokenGT part of a TEAT-GT, converted: a port ``TokenGTEncoder``'s
    state dict."""
    cfg = TeatGTConfig(encoder_layers=2, encoder_attention_heads=4, encoder_embed_dim=32,
                       encoder_ffn_embed_dim=48, lap_node_id_k=k)
    full = {"params": {"tokengt": tree, "subj_fc": _dense(2048, 968), "obj_fc": _dense(2048, 968),
                       "node_label_tokenizer": np.zeros((37, 200)),
                       "gap_gru": {"gate_nn": _dense(32, 1)}}}
    return {key[len("TokenGT_encoder."):]: v for key, v in teatgt_from_jax(full, cfg).items()
            if key.startswith("TokenGT_encoder.")}


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


def test_state_dict_with_the_regularizer_passes_the_audit():
    """With both consistency losses on, the port builds the regularizer's
    modules (and serving's tree is unchanged without them): ``vidsgg``'s
    strict converter takes the port's state dict (it drops ``gat.*`` and
    ``gat_semantic.*``, which it never converts, and consumes the two gates
    and their twins), and the audit passes with the regularizer's subtrees
    set aside, as ``vidsgg``'s own audit sets them aside."""
    jcfg, tcfg = _configs("predcls", use_cons_str_loss=True, use_cons_sem_loss=True)
    port = TeatGT(tcfg, device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert {k.split(".")[0] for k in sd} >= {"gat", "gat_semantic", "gate_nn", "gap",
                                             "gate_sem_nn", "gap_sem"}
    assert torch.equal(port.gate_sem_nn.weight, port.gap_sem.gate_nn.weight)
    converted = convert_teatgt_state_dict(sd, jcfg, strict=True)
    assert {"gap", "gap_sem"} <= set(converted["params"])
    validate_converted_teatgt(converted, expected_teatgt_shapes(jcfg, JEntry.zeros(CAP)))
    serving = TeatGT(_configs("predcls")[1], device="cpu").state_dict()
    assert set(serving) == {k for k in sd if k.split(".")[0] not in (
        "gat", "gat_semantic", "gate_nn", "gap", "gate_sem_nn", "gap_sem")}


REGULARIZER = ("gat", "gat_semantic", "gap", "gap_sem")


GRAPHS = {"edgeless": np.ones(2), "edges": np.array([480.0, 270.0])}


@pytest.fixture(scope="module")
def consistency_runs():
    """``TeatGT._consistency_losses`` of ``vidsgg`` (one jitted value and
    gradient, called on both kinds of frame graph) and of the port, in
    float64, from the same parameters and hidden states: {graphs: (vidsgg's
    losses and gradients, the port's losses, hidden-state gradient and
    parameter gradients)}."""
    jcfg, tcfg = _configs("predcls", caps_name="roomy", use_cons_str_loss=True,
                          use_cons_sem_loss=True)
    rng = np.random.default_rng(12)
    variables = random_tree(expected_teatgt_shapes(jcfg, JEntry.zeros(CAP)), rng, np.float64)
    caps = jcfg.caps
    mp = pytest.MonkeyPatch()
    bridge = EigBridge(mp)
    port = TeatGT(tcfg, device="cpu").double()
    port.load_state_dict(teatgt_from_jax(variables, tcfg))
    runs = {}
    try:
        with jax.enable_x64(True):
            def losses(p, h, entry):
                layout = jgb.build_token_layout(entry, caps)
                s, m = JTeatGT(jcfg).apply({"params": {**variables["params"], **p}}, entry,
                                           layout, None, h, None, False,
                                           method="_consistency_losses")
                return s + 0.37 * m, (s, m)

            value_and_grad = jax.jit(jax.value_and_grad(losses, argnums=(0, 1), has_aux=True))
            params = {k: variables["params"][k] for k in REGULARIZER}
            for graphs, size in GRAPHS.items():
                entry = _entry(21).replace(video_size=size)
                clip_mask = np.asarray(jgb.build_token_layout(entry, caps).clip_mask)
                hidden = rng.standard_normal((caps.n_clips, caps.tokens_per_clip, 32)) * \
                    clip_mask[..., None]
                (_, want), grads = value_and_grad(params, jnp.asarray(hidden), entry)
                want = [float(w) for w in want]
                grads = [jax.tree.map(np.asarray, g) for g in grads]
                port.zero_grad(set_to_none=True)
                tentry = entry_to_torch(entry)
                h = torch.from_numpy(hidden).requires_grad_()
                got = port._consistency_losses(tentry, tgb.build_token_layout(tentry, tcfg.caps),
                                               h)
                (got[0] + 0.37 * got[1]).backward()
                runs[graphs] = (want, grads, [g.detach() for g in got], h.grad, {
                    n: p.grad for n, p in port.named_parameters()})
        bridge.assert_consumed()
    finally:
        mp.undo()
    yield runs


@pytest.mark.parametrize("graphs", list(GRAPHS))
def test_consistency_losses(consistency_runs, graphs):
    """``TeatGT._consistency_losses`` against ``vidsgg``'s in float64: both
    losses, and the gradients of TokenGT's hidden states and of every
    regularizer parameter (of structural + 0.37 x semantic), on per-frame
    graphs without edges (``video_size`` 1, as on ``vidsgg``'s GT-box
    entries: a 0.71 px threshold, so every normalized Laplacian is the
    identity on its nodes and the eigenbasis is whatever the solver
    returns; ``vidsgg``'s gives every frame the same nodes, and the
    structural loss is 0) and with them (AG's 480x270). Both packages
    decompose with ``vidsgg``'s decompositions (``EigBridge``, which also
    holds that no autograd graph reaches the port's ``eigh``)."""
    want, grads, got, h_grad, got_grads = consistency_runs[graphs]
    for name, g, w in zip(("structure_temp_loss", "semantic_temp_loss"), got, want, strict=True):
        _close(g, w, name)
    assert want[1] > 0 and (want[0] > 0) == (graphs == "edges"), want
    _close(h_grad, grads[1], "d hidden")
    want_grads = regularizer_from_jax(grads[0])
    assert {n for n in got_grads if n.split(".")[0] in REGULARIZER + ("gate_nn", "gate_sem_nn")} \
        <= set(want_grads)
    for name, w in want_grads.items():
        if name in got_grads:
            g = got_grads[name]
            # the pooling gates' biases: no gradient in the port, rounding noise in vidsgg's
            _close(np.zeros(w.shape) if g is None else g, w, f"d {name}")
    if graphs == "edges":     # the edge projection sees edges
        assert got_grads["gat.attn_0.edges_to_kv.weight"].abs().max() > 0


def test_regularizer_carry_is_one_to_one():
    """Every leaf of ``vidsgg``'s regularizer subtrees (``gat``,
    ``gat_semantic``, ``gap``, ``gap_sem``) lands in exactly one port
    parameter, with the leaf's shape (a Dense kernel transposed): each leaf
    is filled with values of its own, and each of the port's regularizer
    parameters holds exactly one leaf's, every leaf once (the pooling
    gates' twin names hold the same tensor). A leaf the carry does not
    know raises."""
    jcfg, tcfg = _configs("predcls", use_cons_str_loss=True, use_cons_sem_loss=True)
    shapes = expected_teatgt_shapes(jcfg, JEntry.zeros(CAP))["params"]
    leaves, treedef = jax.tree.flatten({k: shapes[k] for k in REGULARIZER})
    tree = jax.tree.unflatten(treedef, [
        i + np.arange(np.prod(s.shape)).reshape(s.shape) / (np.prod(s.shape) + 1)
        for i, s in enumerate(leaves)])
    sd = regularizer_from_jax(tree)
    port = TeatGT(tcfg, device="cpu")
    held = {k: v for k, v in port.state_dict().items() if k.split(".")[0] in
            REGULARIZER + ("gate_nn", "gate_sem_nn")}
    assert sorted(held) == sorted(sd)
    seen = []
    for name, param in port.named_parameters():
        if name in sd:
            v = sd[name]
            assert v.shape == tuple(param.shape), name
            ids = np.unique(np.floor(v))
            assert len(ids) == 1, (name, ids)
            i = int(ids[0])
            assert v.shape in (tuple(leaves[i].shape), tuple(leaves[i].shape)[::-1]), name
            seen.append(i)
    assert sorted(seen) == list(range(len(leaves)))
    tree["gat"]["attn_0"]["to_extra"] = {"kernel": np.zeros((10, 512))}
    with pytest.raises(ValueError, match="no port key"):
        regularizer_from_jax(tree)


@pytest.mark.parametrize("kw", [dict(node_id_mode="rand"), dict(node_id_mode="orf"),
                                dict(performer=True)])
def test_random_draw_configs_serve_as_vidsgg(kw, monkeypatch):
    """TEAT-GT with random node identifiers or the Performer (predcls, test
    phase) against ``vidsgg``'s on its draws (``PRNGKey(0)`` at test time:
    ``rand``'s uniform identifiers through ``JaxFixedDraws``, the orthogonal
    random matrices through ``DrawBridge``) and decompositions; the
    identifier encoder carries the reference's name (``rand_encoder``,
    ``orf_encoder``). The port's state dict passes ``vidsgg``'s strict
    converter and its audit (which writes every layer's projections under
    ``MultiheadAttention_0``, where a Performer layer's live under
    ``MultiheadPerformerAttention_0``: renamed for the audit)."""
    jcfg, tcfg = _configs("predcls", performer_nb_features=16, **kw)
    shapes = expected_teatgt_shapes(jcfg, JEntry.zeros(CAP))
    port = TeatGT(tcfg, device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    converted = convert_teatgt_state_dict(sd, jcfg, strict=True)
    if tcfg.performer:
        for i in range(tcfg.encoder_layers):
            layer = converted["params"]["tokengt"][f"layer_{i}"]
            layer["MultiheadPerformerAttention_0"] = layer.pop("MultiheadAttention_0")
    validate_converted_teatgt(converted, shapes)
    encoder = port.TokenGT_encoder.graph_encoder.graph_feature.id_encoder_name
    assert encoder == f"{tcfg.node_id_mode}_encoder"

    variables = random_tree(shapes, np.random.default_rng(14), np.float64)
    port = port.double()
    port.load_state_dict(teatgt_from_jax(variables, tcfg))
    EigBridge(monkeypatch)
    draws = DrawBridge(monkeypatch)
    monkeypatch.setattr(ttokengt, "fixed_noise", JaxFixedDraws)
    entry = _entry(15)
    with jax.enable_x64(True):
        jout = jax.tree.map(np.asarray, JTeatGT(jcfg).apply(variables, entry, phase="test"))
    with torch.no_grad():
        out = port(entry_to_torch(entry))
    draws.assert_consumed({"rand": 0, "orf": 1}.get(tcfg.node_id_mode, tcfg.encoder_layers))
    assert sorted(out) == sorted(jout)
    for k in jout:
        _close(out[k], jout[k], k)
