"""PyTorch/CUDA port of the ``vidsgg`` video scene-graph stack.

The package mirrors ``vidsgg``'s module layout (``vidsgg_torch/detector/rpn.py``
is the counterpart of ``vidsgg/detector/rpn.py``, and so on) and keeps its
public tensor layouts: frames ``[F, H, W, 3]``, boxes xyxy with the inclusive
"+1" convention, and :class:`~vidsgg_torch.data.entry.Entry` fields shaped as
in ``vidsgg/data/entry.py``. Inside, modules are ``nn.Module``s in NCHW.

Entry points take ``device=None``, which means the CUDA card; without one
they raise. The CPU is used only when the caller passes ``device="cpu"``.
The package imports neither JAX nor ``vidsgg``.
"""

from vidsgg_torch.device import resolve_device

__all__ = ["resolve_device"]
