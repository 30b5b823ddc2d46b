"""SimCLR-style augmentations and the CARLA agent's training pipeline: the
counterpart of carla_driving_rl_agent_tpu/augment/simclr.py (reference
rl/augmentations/simclr.py, and core/carla_agent.py:527-579 for the
probability-gated pipeline applied to the stacked camera images, gated by
aug_intensity).

The pipeline's randomness is drawn apart from its computation:
`pipeline_draws` makes every raw draw of a minibatch with one generator
call per kind, and `carla_augment_pipeline` computes with them, so that a
test injects JAX's draws.  Every gated branch is computed for every sample
and selected per sample, as jnp.where does.  JAX draws blur3 and blur5
from one key, and cutout and coarse dropout from another; the port draws
each independently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from carla_driving_rl_agent_torch.augment import augmentations as A
from carla_driving_rl_agent_torch.utils.profiling import span

# the pipeline's gates in the order of PipelineDraws.gate (JAX simclr.py
# keys 0, 2, 4, 5, 7, 9 and 11)
GATES = ("jitter", "blur", "blur_size", "salt_and_pepper", "noise", "cutout", "coarse_dropout")
CUTOUT_GRID = 6
COARSE_GRID = 81


class PipelineDraws(NamedTuple):
    """The raw draws of `carla_augment_pipeline` for n samples of (H, W, C)
    frames: uniforms in [0, 1) and standard normals."""
    gate: torch.Tensor          # (n, 7) uniforms, one per gate of GATES
    jitter: torch.Tensor        # (n, 4) uniforms: brightness, contrast, saturation, hue
    blur3: torch.Tensor         # (n, 3, 3) normals
    blur5: torch.Tensor         # (n, 5, 5) normals
    sp_select: torch.Tensor     # (n, H, W) uniforms: salt and pepper's pixels
    sp_value: torch.Tensor      # (n, H, W) uniforms: salt or pepper
    noise_select: torch.Tensor  # (n, H, W) uniforms: gaussian noise's pixels
    noise: torch.Tensor         # (n, H, W, C) normals
    cutout: torch.Tensor        # (n, 6, 6) normals
    coarse: torch.Tensor        # (n, 81, 81) uniforms


def pipeline_draws(generator: torch.Generator, n: int, h: int, w: int, c: int) -> PipelineDraws:
    """Every draw of the pipeline for `n` samples of (h, w, c) frames, on the
    generator's device: one generator call per field."""
    dev = generator.device

    def rand(*shape):
        return torch.rand((n,) + shape, generator=generator, device=dev)

    def randn(*shape):
        return torch.randn((n,) + shape, generator=generator, device=dev)

    return PipelineDraws(gate=rand(len(GATES)), jitter=rand(4), blur3=randn(3, 3),
                         blur5=randn(5, 5), sp_select=rand(h, w), sp_value=rand(h, w),
                         noise_select=rand(h, w), noise=randn(h, w, c),
                         cutout=randn(CUTOUT_GRID, CUTOUT_GRID),
                         coarse=rand(COARSE_GRID, COARSE_GRID))


def color_jitter(image: torch.Tensor, u: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """brightness -> contrast -> saturation -> hue, clipped to [0, 1]
    (reference simclr.py:44-58); `u` (*batch, 4) their uniforms."""
    image = A.brightness(image, u[..., 0], delta=0.2 * strength)
    image = A.contrast(image, u[..., 1], lower=1.0 - 0.8 * strength, upper=1.0 + 0.8 * strength)
    image = A.saturation(image, u[..., 2], lower=1.0 - 0.8 * strength,
                         upper=1.0 + 0.8 * strength)
    image = A.hue(image, u[..., 3], delta=0.2 * strength)
    return torch.clamp(image, 0.0, 1.0)


def color_drop(image: torch.Tensor) -> torch.Tensor:
    """Grayscale repeated to 3 channels (reference simclr.py:61-64)."""
    return A.repeat_channels(A.grayscale(image), n=3)


def color_distortion(image: torch.Tensor, gate: torch.Tensor, jitter: torch.Tensor,
                     strength: float = 1.0, jitter_prob: float = 0.8,
                     drop_prob: float = 0.2) -> torch.Tensor:
    """color_jitter where gate[..., 0] <= jitter_prob, then color_drop where
    gate[..., 1] <= drop_prob; `gate` (*batch, 2) and `jitter` (*batch, 4)
    uniforms."""
    image = torch.where(A.draw_view(gate[..., 0], image) <= jitter_prob,
                        color_jitter(image, jitter, strength), image)
    return torch.where(A.draw_view(gate[..., 1], image) <= drop_prob, color_drop(image), image)


def distort(image: torch.Tensor, draws: PipelineDraws, alpha: float) -> torch.Tensor:
    """The pipeline up to its normalize: the gated color jitter, blur, salt
    and pepper and gaussian noise.  A frame that enters flat (one value,
    as the stacks' zero frames) and meets no blur, salt or noise leaves
    flat up to float32 rounding (~1e-8), which normalize then divides by
    its eps: there the pipeline's output is that rounding, amplified, and
    two implementations agree only up to this point."""
    d = draws

    def gate(name):
        return A.draw_view(d.gate[:, GATES.index(name)], image)

    image = torch.where(gate("jitter") < alpha, color_jitter(image, d.jitter, alpha), image)
    blurred = torch.where(gate("blur_size") >= 0.5, A.gaussian_blur(image, d.blur3),
                          A.gaussian_blur(image, d.blur5))
    image = torch.where(gate("blur") < 0.25 * alpha, blurred, image)
    image = torch.where(gate("salt_and_pepper") < 0.2 * alpha,
                        A.salt_and_pepper(image, d.sp_select, d.sp_value, amount=0.1), image)
    return torch.where(gate("noise") < 0.33 * alpha,
                       A.gaussian_noise(image, d.noise_select, d.noise, amount=0.10, std=0.075),
                       image)


def carla_augment_pipeline(image: torch.Tensor, draws: PipelineDraws,
                           alpha: float) -> torch.Tensor:
    """The CARLAgent training augmentation (reference
    core/carla_agent.py:544-579): `distort` (probability-gated color jitter,
    blur, salt and pepper, gaussian noise), min-max normalize (not gated),
    then gated cutout and coarse dropout.  `image` is (n, ..., H, W, C) in
    [0, 1], `draws` those of n samples of (H, W, C) frames; alpha =
    aug_intensity.  With alpha <= 0 the image is returned as it is."""
    if alpha <= 0.0:
        return image
    image = A.normalize(distort(image, draws, alpha))
    cut = A.draw_view(draws.gate[:, GATES.index("cutout")], image)
    image = torch.where(cut < 0.15 * alpha, A.cutout(image, draws.cutout), image)
    drop = A.draw_view(draws.gate[:, GATES.index("coarse_dropout")], image)
    return torch.where(drop < 0.15 * alpha, A.coarse_dropout(image, draws.coarse, amount=0.04),
                       image)


def augment(generator: torch.Generator, image: torch.Tensor, alpha: float) -> torch.Tensor:
    """The pipeline on `image` (n, ..., H, W, C) with one set of draws per
    sample from `generator`, shared by the sample's frames.  With
    alpha <= 0 nothing is drawn and the image is returned as it is."""
    if alpha <= 0.0:
        return image
    h, w, c = image.shape[-3:]
    with span("augment"):
        return carla_augment_pipeline(image, pipeline_draws(generator, image.shape[0], h, w, c),
                                      alpha)
