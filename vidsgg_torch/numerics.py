"""bfloat16 arithmetic on the host, in NumPy float32 arrays.

``vidsgg``'s NumPy code (the host postprocess, the evaluator) receives
``ml_dtypes.bfloat16`` arrays from a bfloat16 relation stack, and
``ml_dtypes`` computes each bfloat16 operation in float32 and rounds the
result to nearest even. The card's machine has no ``ml_dtypes``, so the
port hands such values over as float32 arrays that hold them exactly, and
rounds with :func:`round_bf16` where ``vidsgg``'s arithmetic stays in
bfloat16.
"""

from __future__ import annotations

import numpy as np


def round_bf16(x) -> np.ndarray:
    """float32 values rounded to bfloat16, nearest even (as float32)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    r = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))
