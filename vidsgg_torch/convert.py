"""Carry ``vidsgg``'s variables across to the port.

``vidsgg``'s Flax variables (nested dicts of NumPy arrays:
``{"params": ..., "batch_stats": ...}``) become ``state_dict``s of the
port's modules, whose keys are the reference's torch checkpoint keys. These
are the exact inverses of ``vidsgg``'s own converters (torch -> Flax), so
those converters audit the port. Needs neither JAX nor ``vidsgg``.

Conventions: Flax Dense kernel [I, O] -> torch Linear weight [O, I]; Flax
Conv kernel [kh, kw, I, O] -> torch Conv2d weight [O, I, kh, kw]; norm
scale -> weight, batch_stats mean/var -> running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch

_STEMS = {"layer1": "RCNN_base.4", "layer2": "RCNN_base.5",
          "layer3": "RCNN_base.6", "layer4": "RCNN_top.0"}
_RPN = {"rpn_conv": "RPN_Conv", "rpn_cls_score": "RPN_cls_score",
        "rpn_bbox_pred": "RPN_bbox_pred"}


def _a(x) -> np.ndarray:
    return np.asarray(x)


def _conv_w(k):
    return np.transpose(_a(k), (3, 2, 0, 1))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _a(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _conv_w(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def _norm(sd, prefix, p, s=None):
    sd[f"{prefix}.weight"] = _a(p["scale"])
    sd[f"{prefix}.bias"] = _a(p["bias"])
    if s is not None:
        sd[f"{prefix}.running_mean"] = _a(s["mean"])
        sd[f"{prefix}.running_var"] = _a(s["var"])


def _to_torch(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def faster_rcnn_from_jax(variables) -> dict:
    """``vidsgg.detector.faster_rcnn.FasterRCNN`` variables -> the port's
    :class:`~vidsgg_torch.detector.faster_rcnn.FasterRCNN` state_dict."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    sd["RCNN_base.0.weight"] = _conv_w(p["base"]["conv1"]["kernel"])
    _norm(sd, "RCNN_base.1", p["base"]["bn1"], s["base"]["bn1"])
    for top in ("base", "head"):
        for name, block in p[top].items():
            stem, _, idx = name.rpartition("_")
            if stem not in _STEMS:
                continue
            prefix = f"{_STEMS[stem]}.{idx}"
            stats = s[top][name]
            for sub, leaf in block.items():
                torch_sub = {"downsample_conv": "downsample.0",
                             "downsample_bn": "downsample.1"}.get(sub, sub)
                if "conv" in sub:
                    sd[f"{prefix}.{torch_sub}.weight"] = _conv_w(leaf["kernel"])
                else:
                    _norm(sd, f"{prefix}.{torch_sub}", leaf, stats[sub])
    for name, torch_name in _RPN.items():
        _conv(sd, f"RCNN_rpn.{torch_name}", p["rpn"][name])
    _linear(sd, "RCNN_cls_score", p["cls_score"])
    _linear(sd, "RCNN_bbox_pred", p["bbox_pred"])
    return _to_torch(sd)


def _mha(sd, prefix, p):
    qkv = ("q_proj", "k_proj", "v_proj")
    sd[f"{prefix}.in_proj_weight"] = np.concatenate([_a(p[q]["kernel"]).T for q in qkv])
    if "bias" in p["q_proj"]:
        sd[f"{prefix}.in_proj_bias"] = np.concatenate([_a(p[q]["bias"]) for q in qkv])
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _encoder_layer(sd, prefix, p):
    _mha(sd, f"{prefix}.self_attn", p["MultiheadAttention_0"])
    _linear(sd, f"{prefix}.linear1", p["Dense_0"])
    _linear(sd, f"{prefix}.linear2", p["Dense_1"])
    _norm(sd, f"{prefix}.norm1", p["LayerNorm_0"])
    _norm(sd, f"{prefix}.norm2", p["LayerNorm_1"])


def _decoder_layer(sd, prefix, p):
    _mha(sd, f"{prefix}.multihead2", p["MultiheadAttention_0"])
    _linear(sd, f"{prefix}.linear1", p["Dense_0"])
    _linear(sd, f"{prefix}.linear2", p["Dense_1"])
    _norm(sd, f"{prefix}.norm3", p["LayerNorm_0"])


def _gmm_head(sd, prefix, p, k):
    """Fused k-major mu/var/pi Denses -> the reference's per-component
    ``heads.{mu,var,pi}_{i}`` Linears."""
    for quant in ("mu", "var", "pi"):
        kern, bias = _a(p[quant]["kernel"]), _a(p[quant]["bias"])
        c = kern.shape[1] // k
        for i in range(k):
            cols = slice(i * c, (i + 1) * c)
            sd[f"{prefix}.heads.{quant}_{i + 1}.weight"] = kern[:, cols].T
            sd[f"{prefix}.heads.{quant}_{i + 1}.bias"] = bias[cols]


def _memory(sd, prefix, p):
    if "mem_attention" in p:
        _mha(sd, f"{prefix}.mem_attention", p["mem_attention"])
    for rel in ("attention", "contacting", "spatial"):
        if f"mem_attention_{rel}" in p:
            _mha(sd, f"{prefix}.mem_attention.{rel}", p[f"mem_attention_{rel}"])
    if "selector" in p:
        _linear(sd, f"{prefix}.selector", p["selector"])


def _vr_fc_weight(kernel):
    """``vidsgg`` flattens the [7, 7, 256] vr map HWC; the reference (and the
    port, NCHW) CHW. Undo the converter's permutation."""
    k = _a(kernel)
    o = k.shape[1]
    return k.reshape(7, 7, 256, o).transpose(3, 2, 0, 1).reshape(o, 256 * 7 * 7)


def _object_classifier(sd, p, s, tracking, obj_head, k):
    """OSPU (``object_classifier.*``, the same layout in TEMPURA and TEAT-GT);
    every tracking layer of the tree."""
    oc, ocs = p["object_classifier"], s["object_classifier"]
    pre = "object_classifier"
    if tracking:
        sd[f"{pre}.positional_encoder.pe"] = _a(ocs["pe_table"])[None]
        for i in range(sum(name.startswith("track_") for name in oc)):
            _encoder_layer(sd, f"{pre}.encoder_tran.layers.{i}", oc[f"track_{i}"])
    sd[f"{pre}.obj_embed.weight"] = _a(oc["obj_embed"])
    _norm(sd, f"{pre}.pos_embed.0", oc["pos_bn"], ocs["pos_bn"])
    _linear(sd, f"{pre}.pos_embed.1", oc["pos_fc"])
    _linear(sd, f"{pre}.intermediate.0", oc["inter_fc"])
    _norm(sd, f"{pre}.intermediate.1", oc["inter_bn"], ocs["inter_bn"])
    if "memory" in oc:
        _memory(sd, pre, oc["memory"])
    if obj_head == "gmm":
        _gmm_head(sd, f"{pre}.decoder_lin", oc["decoder"], k)
    else:
        _linear(sd, f"{pre}.decoder_lin.0", oc["decoder"])


def tempura_from_jax(variables, cfg) -> dict:
    """``vidsgg.models.tempura.Tempura`` variables -> the port's
    :class:`~vidsgg_torch.models.tempura.Tempura` state_dict for ``cfg``."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}

    pf, pfs = p["pair_features"], s.get("pair_features", {})
    _conv(sd, "union_func1", pf["union_func1"])
    _conv(sd, "conv.0", pf["mask_conv1"])
    _norm(sd, "conv.2", pf["mask_bn1"], pfs["mask_bn1"])
    _conv(sd, "conv.4", pf["mask_conv2"])
    _norm(sd, "conv.6", pf["mask_bn2"], pfs["mask_bn2"])
    _linear(sd, "subj_fc", pf["subj_fc"])
    _linear(sd, "obj_fc", pf["obj_fc"])
    sd["vr_fc.weight"] = _vr_fc_weight(pf["vr_fc"]["kernel"])
    sd["vr_fc.bias"] = _a(pf["vr_fc"]["bias"])
    sd["obj_embed.weight"] = _a(pf["obj_embed"])
    sd["obj_embed2.weight"] = _a(pf["obj_embed2"])

    gt = p["glocal_transformer"]
    for i in range(cfg.enc_layers):
        _encoder_layer(sd, f"glocal_transformer.local_attention.layers.{i}", gt[f"enc_{i}"])
    for i in range(cfg.dec_layers):
        _decoder_layer(sd, f"glocal_transformer.global_attention.layers.{i}", gt[f"dec_{i}"])
    sd["glocal_transformer.position_embedding.weight"] = _a(gt["position_embedding"])
    if "memory" in gt:
        _memory(sd, "glocal_transformer", gt["memory"])

    for ours, torch_name in (("a_rel", "a_rel_compress"), ("s_rel", "s_rel_compress"),
                             ("c_rel", "c_rel_compress")):
        if cfg.rel_head == "gmm":
            _gmm_head(sd, torch_name, p[ours], cfg.k)
        else:
            _linear(sd, torch_name, p[ours])

    if cfg.mode != "predcls":
        _object_classifier(sd, p, s, cfg.tracking, cfg.obj_head, cfg.k)
    return _to_torch(sd)


def _leaf_paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,)


def _graph_transformer_keys(p):
    """``vidsgg``'s regularizer ``GraphTransformer`` subtree ``p`` -> its
    (port key, Flax path) pairs (its own layout, which the port keeps):
    ``pos_emb``, then per layer the edge attention, the gated residuals
    (``Dense_0`` -> ``proj``) and the feed-forward."""
    pairs = [("pos_emb", ("pos_emb",))]
    for name in p:
        if name.startswith(("attn_res_", "ff_res_")):
            pairs.append((f"{name}.proj.weight", (name, "Dense_0", "kernel")))
        elif name.startswith("attn_"):
            for proj in ("to_q", "to_k", "to_v", "edges_to_kv", "to_out"):
                pairs += [(f"{name}.{proj}.weight", (name, proj, "kernel")),
                          (f"{name}.{proj}.bias", (name, proj, "bias"))]
        elif name.startswith("ff_"):
            pairs += [(f"{name}.weight", (name, "kernel")), (f"{name}.bias", (name, "bias"))]
    return pairs


def regularizer_from_jax(p) -> dict:
    """The consistency regularizer's subtrees of a ``vidsgg`` TEAT-GT
    params tree ``p`` (``gat``, ``gat_semantic``, ``gap``, ``gap_sem``,
    which ``vidsgg`` has only with a consistency loss on) -> the port's
    keys, each pooling gate under both of its names (``gate_nn`` and
    ``gap.gate_nn``; ``gate_sem_nn`` and ``gap_sem.gate_nn``). A Dense
    kernel is transposed. ``vidsgg``'s own converter drops ``gat.*`` and
    ``gat_semantic.*``, so its audit cannot see this carry; the carry
    audits itself: a leaf of a subtree that no port key takes raises."""
    pairs = []
    for gat in ("gat", "gat_semantic"):
        if gat in p:
            pairs += [(f"{gat}.{key}", (gat,) + path)
                      for key, path in _graph_transformer_keys(p[gat])]
    for gap, gate in (("gap", "gate_nn"), ("gap_sem", "gate_sem_nn")):
        if gap in p:
            for leaf, suffix in (("kernel", "weight"), ("bias", "bias")):
                path = (gap, "gate_nn", leaf)
                pairs += [(f"{gate}.{suffix}", path), (f"{gap}.gate_nn.{suffix}", path)]
    sd: dict = {}
    for key, path in pairs:
        leaf = p
        for k in path:
            leaf = leaf[k]
        sd[key] = _a(leaf).T if path[-1] == "kernel" else _a(leaf)
    left = {(r,) + path for r in ("gat", "gat_semantic", "gap", "gap_sem") if r in p
            for path in _leaf_paths(p[r])} - {path for _, path in pairs}
    if left:
        raise ValueError(f"regularizer carry: leaves with no port key: {sorted(left)}")
    return sd


def teatgt_from_jax(variables, cfg) -> dict:
    """``vidsgg.models.teatgt.TeatGT`` variables -> the port's
    :class:`~vidsgg_torch.models.teatgt.TeatGT` state_dict for ``cfg``
    (the inverse of ``vidsgg/models/convert_teatgt.py``; each pooling
    gate is written under both of its names): TokenGT's softmax or FAVOR+
    projections, its node-identifier encoder under the name of
    ``cfg.node_id_mode``, and in sgcls and sgdet the OSPU. The
    regularizer's subtrees are carried where the tree has them
    (:func:`regularizer_from_jax`)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}
    _linear(sd, "subj_fc", p["subj_fc"])
    _linear(sd, "obj_fc", p["obj_fc"])
    sd["node_label_tokenizer.weight"] = _a(p["node_label_tokenizer"])

    tg = p["tokengt"]
    gf = "TokenGT_encoder.graph_encoder.graph_feature"
    _linear(sd, f"{gf}.atom_encoder", tg["atom_encoder"])
    for name in ("temp_encoder", "edge_encoder", "order_encoder", "graph_token", "null_token"):
        sd[f"{gf}.{name}.weight"] = _a(tg[name])
    # vidsgg routes every kind of node identifier through ``lap_encoder``;
    # the port's encoder has the reference's name for its kind
    _linear(sd, f"{gf}.{cfg.node_id_mode}_encoder", tg["lap_encoder"])
    attn = "MultiheadPerformerAttention_0" if cfg.performer else "MultiheadAttention_0"
    for i in range(cfg.encoder_layers):
        lp, layer = f"TokenGT_encoder.graph_encoder.layers.{i}", tg[f"layer_{i}"]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{lp}.self_attn.{proj}", layer[attn][proj])
        _norm(sd, f"{lp}.self_attn_layer_norm", layer["LayerNorm_0"])
        _norm(sd, f"{lp}.final_layer_norm", layer["LayerNorm_1"])
        _linear(sd, f"{lp}.feedforward.fc1", layer["Dense_0"])
        _linear(sd, f"{lp}.feedforward.fc2", layer["Dense_1"])
    _linear(sd, "TokenGT_encoder.lm_head_transform_weight", tg["lm_head_transform_weight"])
    _norm(sd, "TokenGT_encoder.layer_norm", tg["lm_head_ln"])
    _linear(sd, "TokenGT_encoder.embed_out", tg["embed_out"])
    sd["TokenGT_encoder.lm_output_learned_bias"] = _a(tg["lm_output_bias"])
    for name in ("gate_gru_nn", "gap_gru.gate_nn"):
        _linear(sd, name, p["gap_gru"]["gate_nn"])
    sd.update(regularizer_from_jax(p))

    if cfg.mode != "predcls":
        _object_classifier(sd, p, s, cfg.tracking, "linear", 4)
    return _to_torch(sd)


def memory_from_jax(rel_memory, obj_memory, mem_active):
    """Serving memory banks -> (rel_memory, obj_memory, mem_active) tensors.
    ``rel_memory`` is the joint [26, 1936] bank or, for 'seperate', a dict
    of three banks."""
    if isinstance(rel_memory, dict):
        rel = {k: torch.from_numpy(np.array(v)) for k, v in rel_memory.items()}
    else:
        rel = torch.from_numpy(np.array(rel_memory))
    obj = torch.from_numpy(np.array(obj_memory))
    return rel, obj, torch.tensor(bool(np.asarray(mem_active)))
