"""Video sources for the train and test CLIs (the single-device parts of
``vidsgg/cli/data_source.py``).

Each source is a callable returning an iterator of (entry, fmaps,
gt_annotation), with a :class:`SourceStats` on ``source.stats``:

* synthetic: random base feature maps + a fixed random head stand in for
  the frozen detector (cached-feature bring-up without the AG dataset);
* Action Genome, GT boxes (predcls, sgcls): frames through the detector's
  ResNet base, GT ROIAlign and R-CNN head, each video padded to the
  smallest covering size bucket;
* Action Genome, sgdet: frames through the whole frontend
  (:class:`~vidsgg_torch.detector.SgdetFrontend`, its test or its train
  side), padded to a spatial canvas and a frame-count bucket.

Videos that exceed every bucket, or whose detections exceed the entry's
capacity, are counted as skipped, never dropped silently.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from vidsgg_torch.data import EntryCapacity, build_gt_entry, synthetic_video_annotation
from vidsgg_torch.data.gt_entries import video_counts
from vidsgg_torch.data.synthetic import synthetic_base_fmaps
from vidsgg_torch.detector import FasterRCNN, GtFrontend, RPNConfig, featurize_gt_entry
from vidsgg_torch.detector.checkpoint import load_faster_rcnn_checkpoint
from vidsgg_torch.device import resolve_device

# what is not ported yet, by ROADMAP.md queue 1 item
PAIRED_SERVING = "ROADMAP.md queue 1 item 7b (paired and data-parallel serving)"
PAIRED_TRAINING = "ROADMAP.md queue 1 item 7b (paired sgdet training)"


@dataclasses.dataclass
class SourceStats:
    """Per-epoch accounting: how many videos flowed and how many were
    dropped for exceeding every bucket (never dropped silently)."""

    yielded: int = 0
    skipped: int = 0
    bucket_counts: dict = dataclasses.field(default_factory=dict)

    def reset(self):
        self.yielded = 0
        self.skipped = 0
        self.bucket_counts.clear()

    @property
    def skip_rate(self) -> float:
        total = self.yielded + self.skipped
        return self.skipped / total if total else 0.0


# Spatial canvases (multiples of 16) covering AG's min-side-600 resize:
# landscape, near-square and portrait aspect ratios. Each distinct canvas is
# one set of convolution shapes; proposals still clip to the true (h, w),
# so the zero padding beyond the image edge contributes nothing.
DEFAULT_CANVASES = (
    (608, 816), (608, 1008), (608, 1152),
    (816, 608), (1008, 608), (816, 816),
)


def scale_canvases(frame_size: int, canvases=DEFAULT_CANVASES,
                   base: int = 600):
    """Canvas set for a non-default min-side resize target (--frame_size):
    each default canvas scaled by frame_size/600 and rounded up to /16.
    frame_size == 600 returns the defaults unchanged."""
    if frame_size == base:
        return canvases
    s = frame_size / base
    return tuple(
        (-(-int(round(ch * s)) // 16) * 16, -(-int(round(cw * s)) // 16) * 16)
        for ch, cw in canvases
    )


def pick_canvas(h: int, w: int, canvases=DEFAULT_CANVASES):
    """Smallest-area canvas covering (h, w); None if none fits (the caller
    falls back to the exact /16-padded shape)."""
    best = None
    for ch, cw in canvases:
        if h <= ch and w <= cw and (best is None or ch * cw < best[0] * best[1]):
            best = (ch, cw)
    return best


def default_buckets(
    max_frames: int = 64, objs_per_frame: int = 4, pairs_per_frame: int = 3
) -> list[EntryCapacity]:
    """Ascending video-size buckets (16/32/.../max frames). Short videos
    stop paying the padding of long ones, and videos up to ``max_frames``
    are admitted rather than dropped."""
    buckets = []
    f = 16
    while f < max_frames:
        buckets.append(
            EntryCapacity(f, objs_per_frame * f, pairs_per_frame * f)
        )
        f *= 2
    buckets.append(
        EntryCapacity(max_frames, objs_per_frame * max_frames,
                      pairs_per_frame * max_frames)
    )
    return buckets


def pick_bucket(buckets: list[EntryCapacity], f: int, nb: int, p: int):
    """Smallest bucket covering a video (buckets sorted ascending); None if
    none fits."""
    for b in buckets:
        if f <= b.max_frames and nb <= b.max_objs and p <= b.max_pairs:
            return b
    return None


def synthetic_head_weight() -> torch.Tensor:
    """The synthetic source's stand-in R-CNN head: a fixed [1024, 2048]
    projection, N(0, 0.02^2), drawn on the CPU from seed 7."""
    return torch.randn((1024, 2048), generator=torch.Generator().manual_seed(7)) * 0.02


def make_synthetic_source(n_videos: int, cap: EntryCapacity, seed: int = 0,
                          shuffle: bool = True, stable: bool = False, device=None):
    """Callable returning an iterator of (entry, fmaps, gt_annotation); each
    video has 6 frames of 2 objects (``stable``: the same objects in every
    frame). With ``shuffle`` each call takes a new order from NumPy's
    global random state, as ``vidsgg``'s does. Entries are built under
    ``no_grad`` (a train step can save them for backward)."""
    dev = resolve_device(device)
    w = synthetic_head_weight().to(dev)

    def head(pooled):
        return pooled.mean(dim=(1, 2)) @ w

    videos = []
    for i in range(n_videos):
        ann = synthetic_video_annotation(
            num_frames=6, objs_per_frame=2, seed=seed * 10007 + i, stable=stable,
        )
        entry = build_gt_entry(ann, cap, device=dev)
        fmaps = torch.from_numpy(
            synthetic_base_fmaps(cap.max_frames, hw=(12, 20), seed=seed * 31 + i)
        ).to(dev)
        with torch.no_grad():
            entry = featurize_gt_entry(entry, fmaps, head)
        # detector-style class scores biased toward GT (sgcls/sgdet input)
        rng = np.random.RandomState(i)
        logits = rng.randn(cap.max_objs, 36).astype(np.float32)
        lbl = entry.labels.cpu().numpy()
        logits[np.arange(cap.max_objs), np.clip(lbl - 1, 0, 35)] += 4.0
        dist = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        dist *= entry.obj_mask.cpu().numpy()[:, None]
        entry = dataclasses.replace(entry, distribution=torch.from_numpy(dist).to(dev))
        videos.append((entry, fmaps, ann))

    def source():
        order = np.random.permutation(n_videos) if shuffle else np.arange(n_videos)
        for i in order:
            yield videos[i]

    return source


# frame counts an sgdet video pads to (the smallest that covers it, capped
# by the entry's frames; a longer video keeps its own count)
FRAME_BUCKETS = (8, 16, 32, 64)


def _canvas(h: int, w: int, canvases):
    return pick_canvas(h, w, canvases) or (-(-h // 16) * 16, -(-w // 16) * 16)


def make_ag_source(dataset, buckets: list[EntryCapacity], detector: FasterRCNN,
                   shuffle: bool = True, seed: int = 1123, max_videos: int | None = None,
                   canvases=DEFAULT_CANVASES):
    """Action Genome source (predcls/sgcls GT-box path) on the detector's
    device.

    With ``shuffle`` each call (epoch) takes the next permutation of a
    ``RandomState(seed)`` made with the source, as ``vidsgg``'s does;
    otherwise dataset order. Each video is padded to the smallest covering
    bucket of ``buckets`` (ascending capacities); videos that exceed every
    bucket are skipped. The base runs over all of the bucket's (zero-padded)
    frames.
    """
    dev = detector.device
    front = GtFrontend(detector)
    rng = np.random.RandomState(seed)
    stats = SourceStats()

    def source():
        stats.reset()
        n = len(dataset) if max_videos is None else min(max_videos, len(dataset))
        order = rng.permutation(len(dataset))[:n] if shuffle else np.arange(n)
        for i in order:
            ann = dataset.gt_annotations[i]
            vid_cap = pick_bucket(buckets, *video_counts(ann))
            if vid_cap is None:
                stats.skipped += 1
                continue
            frames, scale = dataset.load_video_frames(i, dev)
            h, w = frames.shape[1:3]
            canvas = _canvas(h, w, canvases)
            pad = frames.new_zeros((vid_cap.max_frames, canvas[0], canvas[1], 3))
            pad[: frames.shape[0], :h, :w] = frames
            entry = build_gt_entry(ann, vid_cap, device=dev)
            entry = dataclasses.replace(
                entry, im_scale=torch.tensor(scale, dtype=torch.float32, device=dev))
            entry, fmaps = front(pad, entry)
            stats.yielded += 1
            key = vid_cap.max_frames
            stats.bucket_counts[key] = stats.bucket_counts.get(key, 0) + 1
            yield entry, fmaps, ann
        if stats.skipped:
            print(
                f"[ag_source] skipped {stats.skipped} over-capacity videos "
                f"({100 * stats.skip_rate:.1f}%)"
            )

    source.stats = stats
    return source


def device_count(device) -> int:
    """Devices of ``device``'s type that serving could shard over: the
    CUDA cards, or one CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def setup_serve_mesh(data_parallel: int, pair_detect: int, max_videos=None, device=None):
    """sgdet serving setup shared by the test CLIs, as ``vidsgg``'s: returns
    ``(None, pair_detect)`` wherever ``vidsgg`` serves on one device, with
    its NOTEs: ``--max_videos`` disables sharding (pairing reorders videos,
    so exact first-N truncation is only well-defined unpaired), and fewer
    devices than requested prints the count. Exits where ``vidsgg`` would
    shard (more than one device after the count): not ported yet."""
    if data_parallel <= 1:
        return None, pair_detect
    if max_videos is not None:
        print("NOTE: --max_videos disables --data_parallel serving "
              "(exact truncation)")
        return None, pair_detect
    n = min(data_parallel, device_count(resolve_device(device)))
    if n < data_parallel:
        print(f"NOTE: only {n} devices available; "
              f"--data_parallel {data_parallel} -> {n}")
    if n <= 1:
        return None, pair_detect
    sys.exit(f"--data_parallel {data_parallel}: sgdet serving sharded over {n} devices "
             f"is not ported to vidsgg_torch yet: {PAIRED_SERVING}")


def resolve_serving_flags(cfg, max_videos, device, prog: str):
    """The test CLIs' handling of ``--max_videos``, ``--pair_detect`` and
    ``--data_parallel`` (``vidsgg/cli/tempura_test.py:42-61``): the same
    NOTEs and, where ``vidsgg`` serves on one device, the same single-device
    serving (``cfg.pair_detect`` is updated in place). Exits where
    ``vidsgg`` would pair or shard sgdet serving, which is not ported."""
    if max_videos is not None and cfg.pair_detect > 1:
        # pairing reorders videos (groups flush when filled) and advances
        # in group steps, so an exact first-N truncation is only
        # well-defined unpaired
        print("NOTE: --max_videos disables --pair_detect (exact truncation)")
        cfg.pair_detect = 1
    if cfg.mode == "sgdet":
        _, cfg.pair_detect = setup_serve_mesh(cfg.data_parallel, cfg.pair_detect,
                                              max_videos, device)
        if cfg.pair_detect > 1:
            sys.exit(f"{prog}: --pair_detect {cfg.pair_detect} (paired sgdet serving) is not "
                     f"ported to vidsgg_torch yet: {PAIRED_SERVING}")
    elif cfg.data_parallel > 1:
        print("NOTE: --data_parallel shards sgdet serving only on the "
              "test CLI (predcls/sgcls eval is single-device here)")


def build_detector(model_path: str | None = None, tiny: bool = False,
                   frame_size: int = 600, device=None):
    """Shared CLI detector construction: (model, canvases).

    ``tiny=True`` builds the shrunk Faster R-CNN (1-block stages, small RPN
    top-n) used for end-to-end rehearsal without the AG checkpoint;
    ``frame_size`` scales the spatial canvas set to match a non-default
    min-side resize target. Without ``model_path`` the weights are random,
    from seed 0."""
    gen = torch.Generator().manual_seed(0)
    if tiny:
        det = FasterRCNN(rpn_cfg=RPNConfig(pre_nms_top_n=64, post_nms_top_n=16),
                         base_blocks=(1, 1, 1), head_blocks=1, device=device, generator=gen)
    else:
        det = FasterRCNN(device=device, generator=gen)
    canvases = scale_canvases(frame_size)
    if model_path:
        load_faster_rcnn_checkpoint(model_path, det)
    else:
        print("WARNING: no detector checkpoint; random detector weights")
    return det, canvases


def make_sgdet_source(
    dataset,
    entry_cap: EntryCapacity,
    frontend,
    is_train: bool = False,
    shuffle: bool = True,
    seed: int = 1123,
    max_videos: int | None = None,
    canvases=DEFAULT_CANVASES,
    pair_detect: int = 1,
):
    """Full-detection source: raw frames -> SgdetFrontend -> (entry, fmaps,
    gt).

    ``dataset`` provides gt_annotations + load_video_frames (ActionGenome).
    Frames pad spatially to a fixed canvas (``pick_canvas``) and temporally
    to a frame-count bucket capped by the entry's frames; the true (h, w)
    still bounds proposal clipping and ``num_frames`` masks the padding
    frames' detections. ``is_train`` builds the train entries (GT
    assignment, SUPPLY, GT pairs). With ``shuffle`` each call (epoch) takes
    the next permutation of a ``RandomState(seed)`` made with the source,
    as ``vidsgg``'s does; otherwise dataset order. A video over the entry's
    frames, or whose detections or train plan exceed a capacity, is counted
    as skipped. Single-video only.
    """
    if pair_detect > 1:
        item = PAIRED_TRAINING if is_train else PAIRED_SERVING
        raise NotImplementedError(f"pair_detect > 1 is not ported yet: {item}")
    rng = np.random.RandomState(seed)
    stats = SourceStats()

    def source():
        stats.reset()
        n = len(dataset) if max_videos is None else min(max_videos, len(dataset))
        order = rng.permutation(len(dataset))[:n] if shuffle else np.arange(n)
        for i in order:
            ann = dataset.gt_annotations[i]
            if len(ann) > entry_cap.max_frames:
                stats.skipped += 1
                continue
            frames, scale = dataset.load_video_frames(int(i), frontend.device)
            f, h, w, _ = frames.shape
            canvas = _canvas(h, w, canvases)
            fpad = next((b for b in FRAME_BUCKETS if f <= b <= entry_cap.max_frames), f)
            pad = frames.new_zeros((fpad, canvas[0], canvas[1], 3))
            pad[:f, :h, :w] = frames
            try:
                entry, fmaps = frontend(pad, (float(h), float(w)), scale,
                                        video_size=(w / scale, h / scale), num_frames=f,
                                        gt_annotation=ann, is_train=is_train)
            except ValueError:  # over-capacity detections or train plan
                stats.skipped += 1
                continue
            stats.yielded += 1
            yield entry, fmaps, ann
        if stats.skipped:
            print(
                f"[sgdet_source] skipped {stats.skipped} over-capacity videos "
                f"({100 * stats.skip_rate:.1f}%)"
            )

    source.stats = stats
    return source
