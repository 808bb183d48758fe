"""Action Genome taxonomy constants (the port's own copy of
``vidsgg/constants.py``).

The reference loads these lists from the dataset's annotation text files and
then patches several names in-place (reference: dataloader/AG/action_genome.py:20-59).
The patched lists are reproduced here so that the framework works without the
dataset present (synthetic tests, demos); the data loader still prefers the
on-disk ``annotations/*.txt`` when a dataset root is given.
"""

from __future__ import annotations

# 36 object classes + '__background__' at index 0
# (action_genome.py:20-31: names read from object_classes.txt then 5 renames).
AG_OBJECT_CLASSES: tuple[str, ...] = (
    "__background__",
    "person", "bag", "bed", "blanket", "book", "box", "broom", "chair",
    "closet/cabinet", "clothes", "cup/glass/bottle", "dish", "door",
    "doorknob", "doorway", "floor", "food", "groceries", "laptop", "light",
    "medicine", "mirror", "paper/notebook", "phone/camera", "picture",
    "pillow", "refrigerator", "sandwich", "shelf", "shoe", "sofa/couch",
    "table", "television", "towel", "vacuum", "window",
)

# 26 predicate classes, split 3 attention / 6 spatial / 17 contacting
# (action_genome.py:33-59).
AG_ATTENTION_RELATIONSHIPS: tuple[str, ...] = (
    "looking_at", "not_looking_at", "unsure",
)
AG_SPATIAL_RELATIONSHIPS: tuple[str, ...] = (
    "above", "beneath", "in_front_of", "behind", "on_the_side_of", "in",
)
AG_CONTACTING_RELATIONSHIPS: tuple[str, ...] = (
    "carrying", "covered_by", "drinking_from", "eating",
    "have_it_on_the_back", "holding", "leaning_on", "lying_on",
    "not_contacting", "other_relationship", "sitting_on", "standing_on",
    "touching", "twisting", "wearing", "wiping", "writing_on",
)
AG_RELATIONSHIP_CLASSES: tuple[str, ...] = (
    AG_ATTENTION_RELATIONSHIPS
    + AG_SPATIAL_RELATIONSHIPS
    + AG_CONTACTING_RELATIONSHIPS
)

NUM_OBJ_CLASSES = len(AG_OBJECT_CLASSES)            # 37 (incl. background)
NUM_ATTENTION = len(AG_ATTENTION_RELATIONSHIPS)     # 3
NUM_SPATIAL = len(AG_SPATIAL_RELATIONSHIPS)         # 6
NUM_CONTACTING = len(AG_CONTACTING_RELATIONSHIPS)   # 17
NUM_PREDICATES = len(AG_RELATIONSHIP_CLASSES)       # 26

# Faster R-CNN preprocessing constants (action_genome.py:183 — BGR pixel
# means, min-side 600 target).
PIXEL_MEANS_BGR = (102.9801, 115.9465, 122.7717)
TARGET_MIN_SIDE = 600
TARGET_MAX_SIDE = 1000

# ROIAlign configuration shared by every pooling site
# (lib/tempura.py:72 — output 7x7, spatial scale 1/16, sampling_ratio 0).
ROI_ALIGN_OUT = 7
ROI_ALIGN_SCALE = 1.0 / 16.0

# Union-box spatial mask resolution (draw_union_boxes(pair_rois, 27),
# e.g. tools/utils/object_detector.py:380).
SPATIAL_MASK_SIZE = 27
