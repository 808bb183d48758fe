"""The random draws of the train phase, through one small interface.

``vidsgg`` draws dropout masks (``jax.random.bernoulli`` inside Flax's
``Dropout``) and the GMM heads' reparameterisation noise
(``jax.random.normal``) from the step's PRNG keys. The port routes every
such draw through a :class:`Noise`, which holds the run's
``torch.Generator``: the model's forward takes it as an argument, and a
test or a device comparison hands it a :class:`ReplayNoise` of recorded
draws instead (:class:`RecordingNoise` records them).

:func:`dropout` is Flax's arithmetic: ``where(mask, x / keep, 0)``.
"""

from __future__ import annotations

import torch

from vidsgg_torch.models.promote import weak


class Noise:
    """Draws from ``generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "Noise":
        return cls(torch.Generator(device=torch.device(device)).manual_seed(seed))

    def normal(self, shape, dtype, device) -> torch.Tensor:
        """Standard normal draws of ``shape``."""
        out = torch.randn(shape, dtype=dtype, device=self.generator.device,
                          generator=self.generator)
        return out.to(device)

    def bernoulli(self, keep: float, shape, device) -> torch.Tensor:
        """A boolean mask of ``shape``, True with probability ``keep``."""
        u = torch.rand(shape, device=self.generator.device, generator=self.generator)
        return (u < keep).to(device)


class RecordingNoise:
    """Draws from ``noise`` and keeps every draw, in call order."""

    def __init__(self, noise):
        self.noise = noise
        self.normals: list[torch.Tensor] = []
        self.masks: list[torch.Tensor] = []

    def normal(self, shape, dtype, device):
        out = self.noise.normal(shape, dtype, device)
        self.normals.append(out.detach().cpu())
        return out

    def bernoulli(self, keep, shape, device):
        out = self.noise.bernoulli(keep, shape, device)
        self.masks.append(out.cpu())
        return out

    def replay(self) -> "ReplayNoise":
        return ReplayNoise(self.normals, self.masks)


class ReplayNoise:
    """Hands out recorded draws in call order; each draw's shape must be
    the one asked for."""

    def __init__(self, normals, masks):
        self.normals = list(normals)
        self.masks = list(masks)

    @staticmethod
    def _next(queue, shape, what):
        if not queue:
            raise AssertionError(f"no recorded {what} draw left for shape {tuple(shape)}")
        out = queue.pop(0)
        if tuple(out.shape) != tuple(shape):
            raise AssertionError(f"recorded {what} draw has shape {tuple(out.shape)}, "
                                 f"asked for {tuple(shape)}")
        return out

    def normal(self, shape, dtype, device):
        return self._next(self.normals, shape, "normal").to(device=device, dtype=dtype)

    def bernoulli(self, keep, shape, device):
        return self._next(self.masks, shape, "bernoulli").to(device)

    def exhausted(self) -> bool:
        return not self.normals and not self.masks


def dropout(x: torch.Tensor, rate: float, noise, deterministic: bool) -> torch.Tensor:
    """Flax's ``Dropout``: the identity when deterministic or at rate 0,
    else ``where(mask, x / keep, 0)`` with a fresh mask of x's shape."""
    if deterministic or rate == 0.0:
        return x
    if noise is None:
        raise ValueError("dropout needs a noise source outside the deterministic phase")
    keep = 1.0 - rate
    mask = noise.bernoulli(keep, x.shape, x.device)
    return torch.where(mask, x / weak(keep, x), torch.zeros_like(x))
