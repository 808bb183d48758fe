"""The whole sgdet serving slice: frames -> SgdetFrontend -> EvalPipeline
("sgdet") -> evaluator pred dict, in the port and in ``vidsgg`` with the
same carried weights (a shrunk ResNet, full-width relation stack).

Both run in float64 (JAX in its x64 context) so that rounding cannot
reorder near-tied scores. Tolerances: every discrete output (labels,
``im_idx``, ``pair_idx``, the GT lists, the overflow route) exact; floats
atol 1e-5 x max(1, max|ref|), since both stacks round the ROIAlign product
and the head output to float32 as ``vidsgg`` does (see
``test_torch_detector.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import assert_pred_equal, random_tree

from vidsgg.data.entry import Entry as JEntry
from vidsgg.data.entry import EntryCapacity as JCap
from vidsgg.detector.faster_rcnn import FasterRCNN as JFasterRCNN
from vidsgg.detector.rpn import RPNConfig as JRPNConfig
from vidsgg.detector.sgdet import SgdetCaps as JCaps
from vidsgg.detector.sgdet import SgdetFrontend as JFrontend
from vidsgg.models.convert_relation import expected_tempura_shapes
from vidsgg.models.tempura import Tempura as JTempura
from vidsgg.models.tempura import TempuraConfig as JConfig
from vidsgg.train.eval_pipeline import EvalPipeline as JEvalPipeline
from vidsgg.train.state import TrainState
from vidsgg_torch.convert import faster_rcnn_from_jax, memory_from_jax, tempura_from_jax
from vidsgg_torch.data.entry import EntryCapacity
from vidsgg_torch.detector import FasterRCNN, RPNConfig, SgdetCaps, SgdetFrontend
from vidsgg_torch.models import Tempura, TempuraConfig
from vidsgg_torch.train import EvalPipeline
from vidsgg_torch.train.state import create_serving_state

F, H, W, DETS = 4, 160, 256, 8
HW = (float(H), float(W))
VIDEO_SIZE = (256.0, 160.0)
TEMPURA_KW = dict(obj_head="linear", rel_head="gmm", enc_layers=1, dec_layers=1,
                  track_layers=1)


@pytest.fixture(scope="module")
def slice_setup():
    rpn = dict(pre_nms_top_n=600, post_nms_top_n=16)
    jdet = JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1,
                       dtype=jnp.float64)
    shapes = jax.eval_shape(
        lambda r: JFasterRCNN(rpn_cfg=JRPNConfig(**rpn), base_blocks=(1, 1, 1),
                              head_blocks=1).init(r, jnp.zeros((1, 64, 64, 3)),
                                                  jnp.array([64.0, 64.0])),
        jax.random.PRNGKey(0))
    det_vars = random_tree(shapes, np.random.default_rng(10), np.float64)
    det_vars["params"]["cls_score"]["kernel"] *= 8.0
    jcap = JCap(F, F * DETS, 48)
    jcfg = JConfig.for_mode("sgdet", **TEMPURA_KW)
    rel_vars = random_tree(expected_tempura_shapes(jcfg, JEntry.zeros(jcap)),
                           np.random.default_rng(11), np.float64)

    det = FasterRCNN(rpn_cfg=RPNConfig(**rpn), base_blocks=(1, 1, 1), head_blocks=1,
                     device="cpu").double()
    det.load_state_dict(faster_rcnn_from_jax(det_vars))
    tcfg = TempuraConfig.for_mode("sgdet", **TEMPURA_KW)
    rel = Tempura(tcfg, device="cpu").double()
    rel.load_state_dict(tempura_from_jax(rel_vars, tcfg))

    frames = (np.random.RandomState(12).randn(F, H, W, 3) * 40.0).astype(np.float32)
    with jax.enable_x64(True):
        jfront = JFrontend(jdet, det_vars, JCaps(dets_per_frame=DETS), jcap)
        jentry, jfmaps = jfront(jnp.asarray(frames), jnp.asarray(HW), 1.0,
                                video_size=VIDEO_SIZE)
    front = SgdetFrontend(det, SgdetCaps(dets_per_frame=DETS),
                          EntryCapacity(F, F * DETS, 48), device="cpu")
    entry, fmaps = front(torch.from_numpy(frames), HW, 1.0, video_size=VIDEO_SIZE)
    banks = np.random.RandomState(13)
    banks = dict(rel=banks.randn(26, 1936), obj=np.zeros((36, 2376)))
    return dict(jcfg=jcfg, rel_vars=rel_vars, jentry=jentry, jfmaps=jfmaps, rel=rel,
                entry=entry, fmaps=fmaps, jcap=jcap, banks=banks)


def _run_both(s, ppf, mem_active):
    rel_mem = s["banks"]["rel"] if mem_active else np.zeros((26, 1936))
    with jax.enable_x64(True):
        state = TrainState(
            step=jnp.zeros((), jnp.int32), params=s["rel_vars"]["params"],
            batch_stats=s["rel_vars"]["batch_stats"], opt_state=None,
            rel_memory=jnp.asarray(rel_mem), obj_memory=jnp.asarray(s["banks"]["obj"]),
            mem_active=jnp.asarray(mem_active), apply_fn=JTempura(s["jcfg"]).apply, tx=None)
        want = JEvalPipeline("sgdet", s["jcap"], union_pairs_per_frame=ppf)(
            state, s["jentry"], s["jfmaps"], gt_entry=s["jentry"])
    tstate = create_serving_state(s["rel"])
    rel_t, obj_t, active = memory_from_jax(rel_mem, s["banks"]["obj"], mem_active)
    tstate.rel_memory, tstate.obj_memory, tstate.mem_active = rel_t, obj_t, active
    pipe = EvalPipeline("sgdet", EntryCapacity(F, F * DETS, 48),
                        union_pairs_per_frame=ppf, device="cpu")
    got = pipe(tstate, s["entry"], s["fmaps"], gt_entry=s["entry"])
    return got, want, pipe.last_route == "host"


def test_slice_fused_path(slice_setup):
    got, want, overflow = _run_both(slice_setup, ppf=2 * DETS, mem_active=True)
    assert not overflow
    assert len(want["pair_idx"]) > 0 and len(want["pred_labels"]) > F
    scale = max(1.0, max(np.abs(np.asarray(v)).max() for k, v in want.items()
                         if k.endswith("distribution") or k == "boxes"))
    assert_pred_equal(got, want, atol=1e-5 * scale)


def test_slice_overflow_takes_host_path(slice_setup):
    got, want, overflow = _run_both(slice_setup, ppf=2, mem_active=False)
    assert overflow
    scale = max(1.0, max(np.abs(np.asarray(v)).max() for k, v in want.items()
                         if k.endswith("distribution") or k == "boxes"))
    assert_pred_equal(got, want, atol=1e-5 * scale)
