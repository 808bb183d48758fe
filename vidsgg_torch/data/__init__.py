from vidsgg_torch.data.action_genome import ActionGenome
from vidsgg_torch.data.entry import Entry, EntryCapacity
from vidsgg_torch.data.gt_entries import build_gt_entry, video_counts
from vidsgg_torch.data.synthetic import synthetic_base_fmaps, synthetic_video_annotation

__all__ = [
    "ActionGenome", "Entry", "EntryCapacity", "build_gt_entry", "synthetic_base_fmaps",
    "synthetic_video_annotation", "video_counts",
]
