"""The random draws of the train phase, through one small interface.

``vidsgg`` draws dropout masks (``jax.random.bernoulli`` inside Flax's
``Dropout``), the GMM heads' reparameterisation noise
(``jax.random.normal``) and TokenGT's Laplacian sign flips
(``jax.random.uniform``) from the step's PRNG keys. The port routes every
such draw through a :class:`Noise`, which holds the run's
``torch.Generator``: the model's forward takes it as an argument, and a
test or a device comparison hands it a :class:`ReplayNoise` of recorded
draws instead (:class:`RecordingNoise` records them). TokenGT's random
node identifiers and the Performer's projection draw even at test time:
there from :func:`fixed_noise`, a CPU generator of a fixed seed, the same
draws on every device.

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

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        """Uniform draws in [0, 1) of ``shape``."""
        out = torch.rand(shape, dtype=dtype, device=self.generator.device,
                         generator=self.generator)
        return out.to(device)


# the test-time draws' seed: vidsgg draws those from jax.random.PRNGKey(0),
# whose threefry values no torch generator reproduces
FIXED_SEED = 0


def fixed_noise() -> Noise:
    """The deterministic phase's draws: a fresh CPU generator seeded
    :data:`FIXED_SEED`, so that every call and every device draws the same
    values."""
    return Noise.seeded(FIXED_SEED, "cpu")


class RecordingNoise:
    """Draws from ``noise`` and keeps every draw, in call order."""

    def __init__(self, noise):
        self.noise = noise
        self.normals: list[torch.Tensor] = []
        self.masks: list[torch.Tensor] = []
        self.uniforms: list[torch.Tensor] = []

    def normal(self, shape, dtype, device):
        out = self.noise.normal(shape, dtype, device)
        self.normals.append(out.detach().cpu())
        return out

    def bernoulli(self, keep, shape, device):
        out = self.noise.bernoulli(keep, shape, device)
        self.masks.append(out.cpu())
        return out

    def uniform(self, shape, dtype, device):
        out = self.noise.uniform(shape, dtype, device)
        self.uniforms.append(out.cpu())
        return out

    def replay(self) -> "ReplayNoise":
        return ReplayNoise(self.normals, self.masks, self.uniforms)


class ReplayNoise:
    """Hands out recorded draws in call order; each draw's shape must be
    the one asked for."""

    def __init__(self, normals, masks, uniforms=()):
        self.normals = list(normals)
        self.masks = list(masks)
        self.uniforms = list(uniforms)

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

    def uniform(self, shape, dtype, device):
        return self._next(self.uniforms, shape, "uniform").to(device=device, dtype=dtype)

    def exhausted(self) -> bool:
        return not self.normals and not self.masks and not self.uniforms


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
