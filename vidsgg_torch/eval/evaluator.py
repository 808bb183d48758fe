"""Scene-graph Recall@K / meanRecall@K evaluator.

The port's own copy of ``vidsgg/eval/evaluator.py``, numerics verbatim
(the grids must be identical, tie order of the unstable ``argsort``
included). One addition: a pred dict whose object scores held bfloat16
values (``adapter.BF16_FIELDS``) gets ``vidsgg``'s bfloat16 product of the
subject and object scores in the "no" constraint, where ``ml_dtypes``
rounds it (every other operation meets a float64 operand first and runs
in float64 in both, every sort included).

A pure-NumPy re-implementation of the reference's
``BasicSceneGraphEvaluator`` (tools/utils/evaluation_recall.py). Every
numeric decision below is matched to the reference so metric outputs are
bit-identical:

* GT triplets: attention <human, obj>, spatial <obj, human>, contacting
  <human, obj> (evaluation_recall.py:105-109).
* Prediction relation rows are the pair list stacked three times — attention
  rows, reversed spatial rows, contacting rows — each padded with zeros
  outside its predicate block over the 26-way space (:125-138).
* Constraint modes: 'with' = per-pair argmax (:237-238); 'semi' = attention
  argmax + multi-label > threshold for spatial/contacting, with block
  identity detected via the zero-padding pattern (:203-223); 'no' =
  (subject score * object score * rel score), global top-100 (:228-233).
* Triplet matching: class-equality intersection + both-box IoU >= 0.5 using
  inclusive-pixel IoU (:385-428); recall accumulated per frame as
  |union(pred_to_gt[:k])| / #gt (:246-274); mR via per-predicate hit/count.

Evaluation is host-side on purpose: it is O(pairs) NumPy per frame and sits
outside the jitted step, exactly where the reference's ``.cpu().numpy()``
boundary was (:125-156).
"""

from __future__ import annotations

import os
import pickle
from functools import reduce

import numpy as np

from vidsgg_torch import constants as C
from vidsgg_torch.eval.adapter import BF16_FIELDS
from vidsgg_torch.numerics import round_bf16


def intersect_2d(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """[m1, n] x [m2, n] -> [m1, m2] row-equality matrix
    (reference tools/utils/pytorch_misc.py:233-247)."""
    if x1.shape[1] != x2.shape[1]:
        raise ValueError("Input arrays must have same #columns")
    return (x1[..., None] == x2.T[None, ...]).all(1)


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Indices sorting a tensor descending, as [numel, ndim] coordinate rows
    (reference pytorch_misc.py:323-330)."""
    return np.column_stack(
        np.unravel_index(np.argsort(-scores.ravel()), scores.shape)
    )


def np_bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the inclusive +1 convention (Cython bbox_overlaps)."""
    boxes = boxes.astype(np.float64)
    query = query.astype(np.float64)
    area_q = (query[:, 2] - query[:, 0] + 1) * (query[:, 3] - query[:, 1] + 1)
    area_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    iw = (
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0])
        + 1
    )
    ih = (
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1])
        + 1
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = area_b[:, None] + area_q[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def _triplet(predicates, relations, classes, boxes, predicate_scores=None,
             class_scores=None):
    """Format (sub, pred, obj) triplets + their boxes (+ scores).

    Reference evaluation_recall.py:353-383.
    """
    sub_ob = classes[relations[:, :2]]
    triplets = np.column_stack((sub_ob[:, 0], predicates, sub_ob[:, 1]))
    triplet_boxes = np.column_stack((boxes[relations[:, 0]], boxes[relations[:, 1]]))
    triplet_scores = None
    if predicate_scores is not None and class_scores is not None:
        triplet_scores = np.column_stack(
            (
                class_scores[relations[:, 0]],
                class_scores[relations[:, 1]],
                predicate_scores,
            )
        )
    return triplets, triplet_boxes, triplet_scores


def _compute_pred_matches(gt_triplets, pred_triplets, gt_boxes, pred_boxes,
                          iou_thresh, phrdet=False):
    """For each prediction, the list of GT triplet indices it matches
    (class equality + both-box IoU). Reference evaluation_recall.py:385-428."""
    keeps = intersect_2d(gt_triplets, pred_triplets)
    gt_has_match = keeps.any(1)
    pred_to_gt = [[] for _ in range(pred_boxes.shape[0])]
    for gt_ind, gt_box, keep_inds in zip(
        np.where(gt_has_match)[0], gt_boxes[gt_has_match], keeps[gt_has_match]
    ):
        boxes = pred_boxes[keep_inds]
        if phrdet:
            gt_u = gt_box.reshape((2, 4))
            gt_u = np.concatenate((gt_u.min(0)[:2], gt_u.max(0)[2:]), 0)
            box_u = boxes.reshape((-1, 2, 4))
            box_u = np.concatenate((box_u.min(1)[:, :2], box_u.max(1)[:, 2:]), 1)
            inds = np_bbox_overlaps(gt_u[None], box_u)[0] >= iou_thresh
        else:
            sub_iou = np_bbox_overlaps(gt_box[None, :4], boxes[:, :4])[0]
            obj_iou = np_bbox_overlaps(gt_box[None, 4:], boxes[:, 4:])[0]
            inds = (sub_iou >= iou_thresh) & (obj_iou >= iou_thresh)
        for i in np.where(keep_inds)[0][inds]:
            pred_to_gt[i].append(int(gt_ind))
    return pred_to_gt


def _evaluate_recall(gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes,
                     pred_classes, rel_scores, cls_scores, iou_thresh=0.5,
                     phrdet=False):
    """Sort predicted triplets by score product and match against GT.

    Reference evaluation_recall.py:280-350.
    """
    if pred_rels.size == 0:
        return [[]]
    assert gt_rels.shape[0] != 0
    assert pred_rels[:, :2].max() < pred_classes.shape[0]

    gt_triplets, gt_triplet_boxes, _ = _triplet(
        gt_rels[:, 2], gt_rels[:, :2], gt_classes, gt_boxes
    )
    pred_triplets, pred_triplet_boxes, relation_scores = _triplet(
        pred_rels[:, 2], pred_rels[:, :2], pred_classes, pred_boxes,
        rel_scores, cls_scores,
    )
    order = relation_scores.prod(1).argsort()[::-1]
    pred_triplets = pred_triplets[order]
    pred_triplet_boxes = pred_triplet_boxes[order]
    return _compute_pred_matches(
        gt_triplets, pred_triplets, gt_triplet_boxes, pred_triplet_boxes,
        iou_thresh, phrdet=phrdet,
    )


class SceneGraphEvaluator:
    """Accumulates R@{10,20,50,100} and per-predicate hits over frames.

    Mirrors the reference constructor/fields (evaluation_recall.py:9-27) so
    downstream tooling can read ``result_dict[mode + '_recall']`` etc.
    """

    KS = (10, 20, 50, 100)

    def __init__(self, mode, object_classes=C.AG_OBJECT_CLASSES,
                 all_predicates=C.AG_RELATIONSHIP_CLASSES,
                 attention_predicates=C.AG_ATTENTION_RELATIONSHIPS,
                 spatial_predicates=C.AG_SPATIAL_RELATIONSHIPS,
                 contacting_predicates=C.AG_CONTACTING_RELATIONSHIPS,
                 iou_threshold=0.5, constraint="with", semithreshold=None,
                 output_dir=None):
        self.mode = mode
        self.constraint = constraint
        self.iou_threshold = iou_threshold
        self.semithreshold = semithreshold
        self.object_classes = list(object_classes)
        self.all_predicates = list(all_predicates)
        self.attention_predicates = list(attention_predicates)
        self.spatial_predicates = list(spatial_predicates)
        self.contacting_predicates = list(contacting_predicates)
        self.tot_all_predicates = len(self.all_predicates)
        self.output_dir = output_dir
        self.per_class_recall = {}
        self.result_dict = {}
        self.reset_result()

    # -- result accounting ---------------------------------------------------

    def reset_result(self):
        self.result_dict[self.mode + "_recall"] = {k: [] for k in self.KS}
        self.result_dict[self.mode + "_recall_hit"] = {
            k: [0] * self.tot_all_predicates for k in self.KS
        }
        self.result_dict[self.mode + "_recall_count"] = {
            k: [0] * self.tot_all_predicates for k in self.KS
        }

    def recall_at(self, k: int) -> float:
        vals = self.result_dict[self.mode + "_recall"][k]
        return float(np.mean(vals)) if vals else 0.0

    def mean_recall_at(self, k: int) -> float:
        hit = self.result_dict[self.mode + "_recall_hit"][k]
        cnt = self.result_dict[self.mode + "_recall_count"][k]
        avg = sum(
            float(hit[i]) / float(cnt[i] + 1e-10)
            for i in range(self.tot_all_predicates)
        )
        return avg / self.tot_all_predicates

    def calc_mrecall(self):
        """Reference calc_mrecall (evaluation_recall.py:34-51)."""
        out = {}
        for k in self.KS:
            self.per_class_recall[k] = {}
            hit = self.result_dict[self.mode + "_recall_hit"][k]
            cnt = self.result_dict[self.mode + "_recall_count"][k]
            avg = 0.0
            for idx in range(self.tot_all_predicates):
                v = float(hit[idx]) / float(cnt[idx] + 1e-10)
                avg += v
                self.per_class_recall[k][self.all_predicates[idx]] = v
            out[k] = avg / self.tot_all_predicates
        self.result_dict[self.mode + "_Mrecall"] = out
        return out

    def print_stats(self, log_file=None, metric=None):
        """Reference print_stats (evaluation_recall.py:54-83) incl. the
        per-class recall pickle dumps when ``output_dir`` is set."""
        print(f"--------- {metric}_{self.mode} ({self.constraint} constraint) ---------")
        if log_file:
            log_file.write("-" * 15 + str(self.constraint) + "_constraint\n")
        for k in self.KS:
            r = self.recall_at(k)
            mr = self.mean_recall_at(k)
            print("R@%i: %f" % (k, r), flush=True)
            print("mR@%i: %f" % (k, mr), flush=True)
            if log_file:
                log_file.write("R@%i: %f \n" % (k, r))
                log_file.write("mR@%i: %f \n" % (k, mr))
            if self.output_dir:
                os.makedirs(self.output_dir, exist_ok=True)
                per_cls = {
                    self.all_predicates[i]: float(
                        self.result_dict[self.mode + "_recall_hit"][k][i]
                    )
                    / float(
                        self.result_dict[self.mode + "_recall_count"][k][i] + 1e-10
                    )
                    for i in range(self.tot_all_predicates)
                }
                path = os.path.join(
                    self.output_dir,
                    f"{self.mode}_{self.constraint}_constraint_per_cls_recall_at_{k}.pkl",
                )
                with open(path, "wb") as f:
                    pickle.dump(per_cls, f)

    # -- per-video evaluation -------------------------------------------------

    def evaluate_scene_graph(self, gt, pred):
        """Evaluate one video.

        Args:
          gt: list of per-frame annotation lists; frame[0] carries
            'person_bbox' [1,4]; subsequent dicts carry 'bbox' [4], 'class',
            'attention_relationship' (list/array of indices),
            'spatial_relationship', 'contacting_relationship'.
          pred: dict of NumPy arrays with keys boxes [N,5], im_idx [P],
            pair_idx [P,2], attention/spatial/contacting_distribution
            [P,3|6|17], and labels+scores (predcls) or
            pred_labels+pred_scores (sgcls/sgdet).
        """
        im_idx = np.asarray(pred["im_idx"])
        pair_idx = np.asarray(pred["pair_idx"])
        a_dist = np.asarray(pred["attention_distribution"])
        s_dist = np.asarray(pred["spatial_distribution"])
        c_dist = np.asarray(pred["contacting_distribution"])
        boxes = np.asarray(pred["boxes"])
        if self.mode == "predcls":
            pred_classes_all = np.asarray(pred["labels"])
            score_key = "scores"
            obj_scores_all = np.asarray(pred["scores"])
        else:
            pred_classes_all = np.asarray(pred["pred_labels"])
            score_key = "pred_scores"
            obj_scores_all = np.asarray(pred["pred_scores"])

        n_att = len(self.attention_predicates)
        n_spa = len(self.spatial_predicates)
        n_con = len(self.contacting_predicates)
        att_base = 0
        spa_base = n_att
        con_base = n_att + n_spa

        for idx, frame_gt in enumerate(gt):
            gt_boxes = np.zeros([len(frame_gt), 4])
            gt_classes = np.zeros(len(frame_gt))
            gt_relations = []
            human_idx = 0
            gt_classes[human_idx] = 1
            gt_boxes[human_idx] = np.asarray(frame_gt[0]["person_bbox"]).reshape(-1)[:4]
            for m, n in enumerate(frame_gt[1:]):
                gt_boxes[m + 1, :] = n["bbox"]
                gt_classes[m + 1] = n["class"]
                gt_relations.append(
                    [human_idx, m + 1, att_base + int(np.asarray(n["attention_relationship"]).reshape(-1)[0])]
                )
                for spatial in np.asarray(n["spatial_relationship"]).reshape(-1).tolist():
                    gt_relations.append([m + 1, human_idx, spa_base + int(spatial)])
                for contact in np.asarray(n["contacting_relationship"]).reshape(-1).tolist():
                    gt_relations.append([human_idx, m + 1, con_base + int(contact)])
            gt_rels = np.array(gt_relations)

            sel = im_idx == idx
            pairs = pair_idx[sel]
            p = pairs.shape[0]
            # stacked relation rows: attention / reversed spatial / contacting
            rels_i = np.concatenate((pairs, pairs[:, ::-1], pairs), axis=0)
            z_att = np.zeros([p, n_att])
            z_spa = np.zeros([p, n_spa])
            z_con = np.zeros([p, n_con])
            scores_att = np.concatenate((a_dist[sel], z_spa, z_con), axis=1)
            scores_spa = np.concatenate((z_att, s_dist[sel], z_con), axis=1)
            scores_con = np.concatenate((z_att, z_spa, c_dist[sel]), axis=1)
            rel_scores = np.concatenate((scores_att, scores_spa, scores_con), axis=0)

            self._evaluate_frame(
                gt_rels,
                gt_boxes.astype(float),
                gt_classes,
                rels_i,
                boxes[:, 1:].astype(float),
                pred_classes_all,
                obj_scores_all,
                rel_scores,
                bf16_scores=score_key in pred.get(BF16_FIELDS, ()),
            )

    def _evaluate_frame(self, gt_rels, gt_boxes, gt_classes, pred_rel_inds,
                        pred_boxes, pred_classes, obj_scores, rel_scores,
                        bf16_scores=False):
        """Constraint filtering + matching + accumulation
        (reference evaluate_from_dict, evaluation_recall.py:180-276)."""
        threshold = self.semithreshold if self.semithreshold is not None else 0.9
        n_att = len(self.attention_predicates)
        spa0 = n_att  # first spatial column
        con0 = n_att + len(self.spatial_predicates)

        if self.constraint == "semi":
            pred_rels, predicate_scores = [], []
            for i, j in enumerate(pred_rel_inds):
                # block identity via the zero-padding pattern, as the
                # reference does (checks columns 0+1 / 3+4 / 9+10)
                if rel_scores[i, 0] + rel_scores[i, 1] > 0:
                    pred_rels.append(np.append(j, rel_scores[i].argmax()))
                    predicate_scores.append(rel_scores[i].max())
                elif rel_scores[i, spa0] + rel_scores[i, spa0 + 1] > 0:
                    for k in np.where(rel_scores[i] > threshold)[0]:
                        pred_rels.append(np.append(j, k))
                        predicate_scores.append(rel_scores[i, k])
                elif rel_scores[i, con0] + rel_scores[i, con0 + 1] > 0:
                    for k in np.where(rel_scores[i] > threshold)[0]:
                        pred_rels.append(np.append(j, k))
                        predicate_scores.append(rel_scores[i, k])
            pred_rels = np.array(pred_rels)
            predicate_scores = np.array(predicate_scores)
        elif self.constraint == "no":
            obj_scores_per_rel = obj_scores[pred_rel_inds].prod(1)
            if bf16_scores:  # exact in float32: one rounding is ml_dtypes'
                obj_scores_per_rel = round_bf16(obj_scores_per_rel)
            overall = obj_scores_per_rel[:, None] * rel_scores
            score_inds = argsort_desc(overall)[:100]
            pred_rels = np.column_stack(
                (pred_rel_inds[score_inds[:, 0]], score_inds[:, 1])
            )
            predicate_scores = rel_scores[score_inds[:, 0], score_inds[:, 1]]
        else:  # 'with'
            pred_rels = np.column_stack((pred_rel_inds, rel_scores.argmax(1)))
            predicate_scores = rel_scores.max(1)

        if pred_rels.size == 0:
            pred_to_gt = [[]]
        else:
            pred_to_gt = _evaluate_recall(
                gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes,
                pred_classes, predicate_scores, obj_scores,
                iou_thresh=self.iou_threshold,
            )

        rd = self.result_dict
        for k in self.KS:
            match = reduce(np.union1d, pred_to_gt[:k])
            for m in range(len(match)):
                label = int(gt_rels[int(match[m]), 2])
                rd[self.mode + "_recall_hit"][k][label] += 1
            for idx in range(gt_rels.shape[0]):
                rd[self.mode + "_recall_count"][k][int(gt_rels[idx, 2])] += 1
            rd[self.mode + "_recall"][k].append(
                float(len(match)) / float(gt_rels.shape[0])
            )


def get_ag_evaluators(mode, output_dir=None, **class_kwargs):
    """The (with, semi@0.9, no) evaluator triple
    (reference Get_AG_Evaluator, evaluation_recall.py:430-465)."""
    mk = lambda constraint, semithreshold=None: SceneGraphEvaluator(
        mode,
        constraint=constraint,
        semithreshold=semithreshold,
        iou_threshold=0.5,
        output_dir=output_dir,
        **class_kwargs,
    )
    return mk("with"), mk("semi", 0.9), mk("no")
