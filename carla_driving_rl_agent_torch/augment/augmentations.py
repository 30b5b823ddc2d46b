"""Image augmentations: the counterpart of
carla_driving_rl_agent_tpu/augment/augmentations.py (reference
rl/augmentations/augmentations.py), with the same ops and default
strengths.

Images are float tensors (..., H, W, C) in [0, 1]: one frame, or frames
with any leading dims.  Statistics (a channel's mean, the gray image, the
min and max) are taken per frame.

An op that is random takes its raw draws as arguments and never a
generator: uniforms in [0, 1) and standard normals, shaped (*batch, *core),
where `batch` is a prefix of the image's leading dims (the learner's (mb, T)
stacks pass (mb, ...) draws, so that a sample's T frames share them) and
`core` is the draw's own shape.  Each op scales its draws to its range
itself, as jax.random.uniform(minval, maxval) does (u * (max - min) + min in
float32), so that a test can inject JAX's raw draws.  Integer draws (crop's
offsets, jpeg_quality's quality) are passed as drawn.

The constant tensors are made once per device and dtype, so that a call
after the first copies nothing from the host (and can be captured in a
CUDA graph).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)
TO_YIQ = ((0.299, 0.587, 0.114),
          (0.596, -0.274, -0.322),
          (0.211, -0.523, 0.312))
SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
# JPEG luminance quantization table (ITU-T T.81 Annex K.1)
JPEG_Q50 = ((16, 11, 10, 16, 24, 40, 51, 61), (12, 12, 14, 19, 26, 58, 60, 55),
            (14, 13, 16, 24, 40, 57, 69, 56), (14, 17, 22, 29, 51, 87, 80, 62),
            (18, 22, 37, 56, 68, 109, 103, 77), (24, 35, 55, 64, 81, 104, 113, 92),
            (49, 64, 78, 87, 103, 121, 120, 101), (72, 92, 95, 98, 112, 100, 103, 99))


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype) -> dict:
    """The ops' constant tensors on `device`, in the dtype JAX gives them:
    the gray weights, the YIQ matrix and its inverse (as jnp.linalg.inv
    computes it, in that dtype), Sobel's kernels and the DCT matrix in the
    image's dtype, the JPEG table in float32."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    to_yiq = np.asarray(TO_YIQ, np_dtype)
    sobel_x = torch.tensor(SOBEL_X, dtype=dtype, device=device)
    return dict(gray=torch.tensor(GRAY_WEIGHTS, dtype=dtype, device=device),
                to_yiq=torch.from_numpy(to_yiq).to(device),
                from_yiq=torch.from_numpy(np.linalg.inv(to_yiq).astype(np_dtype)).to(device),
                sobel_x=sobel_x, sobel_y=sobel_x.T.contiguous(),
                jpeg_q50=torch.tensor(JPEG_Q50, dtype=torch.float32, device=device),
                dct8=_dct8(device, dtype))


def _const(image: torch.Tensor, name: str) -> torch.Tensor:
    return _constants(image.device, image.dtype)[name]


def draw_view(x: torch.Tensor, image: torch.Tensor, core: int = 0) -> torch.Tensor:
    """Draws `x` of shape (*batch, *core) viewed to broadcast against
    `image` (..., H, W, C): `batch` against the image's leading dims, and
    the `core` trailing dims against its (H,), (H, W) or (H, W, C)."""
    nb = x.dim() - core
    return x.reshape(x.shape[:nb] + (1,) * (image.dim() - nb - 3) + x.shape[nb:]
                     + (1,) * (3 - core))


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jax.random.uniform's scaling of raw uniforms `u` to [lo, hi):
    u * (hi - lo) + lo in float32, then the max with lo."""
    lo32 = np.float32(lo)
    span = np.float32(hi) - lo32
    return torch.clamp(u * float(span) + float(lo32), min=float(lo32))


def nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """jax.image.resize's nearest source index of each of `n_out` outputs
    over `n_in` inputs: floor((i + 0.5) * n_in / n_out) in float32 (the
    half-pixel index; torch's mode="nearest" differs)."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * float(n_in) / float(n_out)).to(torch.int64)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) -> (..., H, W), nearest with JAX's index."""
    rows = nearest_index(x.shape[-2], size[0], x.device)
    cols = nearest_index(x.shape[-1], size[1], x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def _depthwise(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Every channel of every frame of `image` (..., H, W, C)
    cross-correlated with `kernel` (*batch, k, k), k odd, with SAME zero
    padding: one grouped convolution."""
    lead, (h, w, c) = image.shape[:-3], image.shape[-3:]
    k = kernel.shape[-1]
    nb = kernel.dim() - 2
    weight = kernel.reshape(kernel.shape[:nb] + (1,) * (len(lead) - nb) + (1, k, k))
    weight = weight.expand(lead + (c, k, k)).reshape(-1, 1, k, k)
    x = torch.movedim(image, -1, -3).reshape(1, -1, h, w)
    out = F.conv2d(x, weight.to(image.dtype), padding=k // 2, groups=x.shape[1])
    return torch.movedim(out.reshape(lead + (c, h, w)), -3, -1)


# -------------------------------------------------------------------------
# Geometric / spatial
# -------------------------------------------------------------------------

def resize(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to (H, W) with half-pixel centres, anti-aliased when
    it shrinks, as jax.image.resize(method="bilinear") (reference
    `tf_resize`)."""
    lead, c = image.shape[:-3], image.shape[-1]
    x = torch.movedim(image, -1, -3).reshape((-1, c) + tuple(image.shape[-3:-1]))
    out = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=True)
    return torch.movedim(out.reshape(lead + out.shape[1:]), -3, -1)


def crop(image: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: Tuple[int, int],
         do_resize: bool = False) -> torch.Tensor:
    """The (ch, cw) window at rows y0 and columns x0 (reference `tf_crop`;
    JAX draws the offsets with randint in [0, max(H - ch, 0)] and
    [0, max(W - cw, 0)]), resized back to (H, W) with `do_resize`."""
    h, w, c = image.shape[-3:]
    ch, cw = size
    dev = image.device
    rows = draw_view(y0, image) + torch.arange(ch, device=dev).reshape(ch, 1, 1)
    out = torch.gather(image, -3, rows.expand(image.shape[:-3] + (ch, w, c)))
    cols = draw_view(x0, image) + torch.arange(cw, device=dev).reshape(cw, 1)
    out = torch.gather(out, -2, cols.expand(image.shape[:-3] + (ch, cw, c)))
    return resize(out, (h, w)) if do_resize else out


def flip(image: torch.Tensor, u_h: torch.Tensor, u_v: torch.Tensor,
         horizontal: bool = True, vertical: bool = False) -> torch.Tensor:
    """Left-right where u_h < 0.5 (with `horizontal`), then upside down
    where u_v < 0.5 (with `vertical`) (reference `tf_flip`)."""
    if horizontal:
        image = torch.where(draw_view(u_h, image) < 0.5, image.flip(-2), image)
    if vertical:
        image = torch.where(draw_view(u_v, image) < 0.5, image.flip(-3), image)
    return image


def rotate(image: torch.Tensor, degrees: int = 90) -> torch.Tensor:
    """Rotation by a multiple of 90 degrees (reference `tf_rotate`)."""
    if degrees % 90:
        raise ValueError(f"degrees must be a multiple of 90, got {degrees}")
    return torch.rot90(image, degrees // 90, dims=(-3, -2))


def cutout(image: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Zero the argmax cell of the (size, size) grid of `normal`, resized
    nearest to the image (reference `tf_cutout`)."""
    top = torch.amax(normal, dim=(-2, -1), keepdim=True)
    mask = torch.where(normal == top, 0.0, 1.0).to(image.dtype)
    return image * draw_view(resize_nearest(mask, image.shape[-3:-1]), image, 2)


def coarse_dropout(image: torch.Tensor, u: torch.Tensor, amount: float = 0.1) -> torch.Tensor:
    """Zero the cells of the (size, size) grid of `u` where u <= amount,
    resized nearest to the image (reference `tf_coarse_dropout`)."""
    mask = (u > amount).to(image.dtype)
    return image * draw_view(resize_nearest(mask, image.shape[-3:-1]), image, 2)


# -------------------------------------------------------------------------
# Appearance
# -------------------------------------------------------------------------

def _rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    return torch.sum(image[..., :3] * _const(image, "gray"), dim=-1, keepdim=True)


def grayscale(image: torch.Tensor) -> torch.Tensor:
    """RGB -> one channel of luminance (reference `tf_grayscale`)."""
    return _rgb_to_gray(image)


def repeat_channels(image: torch.Tensor, n: int = 3) -> torch.Tensor:
    return torch.repeat_interleave(image, n, dim=-1)


def brightness(image: torch.Tensor, u: torch.Tensor, delta: float = 0.75) -> torch.Tensor:
    """Add d in [-delta, delta) (reference `tf_brightness`)."""
    return image + draw_view(_uniform(u, -delta, delta), image)


def contrast(image: torch.Tensor, u: torch.Tensor, lower: float = 0.4,
             upper: float = 1.6) -> torch.Tensor:
    """Scale each channel about its mean over the frame by f in
    [lower, upper) (reference `tf_contrast`)."""
    f = draw_view(_uniform(u, lower, upper), image)
    mean = torch.mean(image, dim=(-3, -2), keepdim=True)
    return (image - mean) * f + mean


def saturation(image: torch.Tensor, u: torch.Tensor, lower: float = 0.5,
               upper: float = 1.5) -> torch.Tensor:
    """Blend with the gray image by f in [lower, upper) (reference
    `tf_saturation`)."""
    f = draw_view(_uniform(u, lower, upper), image)
    gray = _rgb_to_gray(image)
    return gray + (image - gray) * f


def _mix(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x[..., :3] @ m.T as multiply-adds, one output channel at a time:
    every pixel takes the same operations in the same order on any device
    (a matrix product's blocking need not)."""
    return torch.stack([x[..., 0] * m[i, 0] + x[..., 1] * m[i, 1] + x[..., 2] * m[i, 2]
                        for i in range(3)], dim=-1)


def hue(image: torch.Tensor, u: torch.Tensor, delta: float = 0.5) -> torch.Tensor:
    """Rotate the chroma in YIQ space by theta in [-delta, delta) * pi
    (reference `tf_hue`)."""
    theta = draw_view(_uniform(u, -delta, delta) * math.pi, image)[..., 0]
    cos_h, sin_h = torch.cos(theta), torch.sin(theta)
    yiq = _mix(image, _const(image, "to_yiq"))
    rot = torch.stack([yiq[..., 0],
                       yiq[..., 1] * cos_h - yiq[..., 2] * sin_h,
                       yiq[..., 1] * sin_h + yiq[..., 2] * cos_h], dim=-1)
    return _mix(rot, _const(image, "from_yiq"))


def gaussian_noise(image: torch.Tensor, select_u: torch.Tensor, normal: torch.Tensor,
                   amount: float = 0.25, std: float = 0.2) -> torch.Tensor:
    """Add normal * std, clipped to [0, 1] (so only its positive part), on
    the pixels where select_u (*batch, H, W) < amount; `normal` is
    (*batch, H, W, C) (reference `tf_gaussian_noise`)."""
    select = (select_u < amount).to(image.dtype)
    noise = torch.clamp(normal * std, 0.0, 1.0)
    return image + draw_view(select, image, 2) * draw_view(noise, image, 3)


def salt_and_pepper(image: torch.Tensor, select_u: torch.Tensor, value_u: torch.Tensor,
                    amount: float = 0.1, prob: float = 0.5) -> torch.Tensor:
    """Set the pixels where select_u < amount / 10 to 1 where value_u < prob,
    else to 0; both draws (*batch, H, W) (reference `tf_salt_and_pepper`)."""
    select = draw_view((select_u < amount / 10.0).to(image.dtype), image, 2)
    noise = draw_view((value_u < prob).to(image.dtype), image, 2)
    return image * (1 - select) + noise * select


def gaussian_blur(image: torch.Tensor, normal: torch.Tensor, std: float = 0.25) -> torch.Tensor:
    """Depthwise blur with the random near-one kernel normal * std + 1 over
    its sum; `normal` (*batch, size, size) (the reference's idiosyncratic
    `tf_gaussian_blur`).  The kernel is not symmetric: it is applied as a
    cross-correlation, as XLA's convolution does."""
    kernel = normal * std + 1.0
    return _depthwise(image, kernel / torch.sum(kernel, dim=(-2, -1), keepdim=True))


def median_blur(image: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Box filter (the reference's `tf_median_blur` is an unweighted box sum
    by a depthwise convolution of ones; normalised here)."""
    kernel = torch.full((size, size), 1.0 / (size * size), dtype=image.dtype,
                        device=image.device)
    return _depthwise(image, kernel)


def multiply_channels(image: torch.Tensor, u: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """Multiply the channels by the softmax of logits in [-1, 1), `u`
    (*batch, C), times `strength`, then normalize (reference
    `tf_multiply_channels`)."""
    alpha = torch.softmax(_uniform(u, -1.0, 1.0), dim=-1) * strength
    alpha = alpha.reshape(alpha.shape[:-1] + (1,) * (image.dim() - alpha.dim())
                          + alpha.shape[-1:])
    return normalize(image * alpha)


def sobel(image: torch.Tensor) -> torch.Tensor:
    """Sobel edges dx + dy (reference `tf_sobel`)."""
    return (_depthwise(image, _const(image, "sobel_x"))
            + _depthwise(image, _const(image, "sobel_y")))


def normalize(image: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Min-max scaling of each frame to [0, 1] (reference `tf_normalize`)."""
    lo = torch.amin(image, dim=(-3, -2, -1), keepdim=True)
    hi = torch.amax(image, dim=(-3, -2, -1), keepdim=True)
    return (image - lo) / torch.clamp(hi - lo, min=eps)


def _dct8(device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Orthonormal 8-point DCT-II matrix: the cosines in float32, the scale
    in `dtype`, as the JAX package computes them."""
    k = torch.arange(8, dtype=torch.float32, device=device)
    d = torch.cos((2.0 * k[None, :] + 1.0) * k[:, None] * math.pi / 16.0)
    scale = torch.full((8, 1), 0.5, dtype=dtype, device=device)
    scale[0, 0] = 1.0 / (2.0 * torch.sqrt(torch.tensor(2.0, dtype=dtype)))
    return d.to(dtype) * scale


def jpeg_quality(image: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG-compression artifacts at `quality` (*batch) (JAX draws it with
    randint in [min_quality, max_quality], default [20, 95]): 8x8 block
    DCT of each channel, quantisation by the standard table at that
    quality, inverse DCT; no entropy coding (the JAX package's analog of
    the reference's `tf_quality`)."""
    h, w, c = image.shape[-3:]
    q = quality.to(torch.float32)
    # ITU quality -> table scale: 5000/q below 50, 200-2q above
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q) / 100.0
    table = torch.clamp(torch.round(_const(image, "jpeg_q50") * scale[..., None, None]),
                        1.0, 255.0)
    lead = image.shape[:-3]
    table = table.reshape(table.shape[:-2] + (1,) * (len(lead) - (table.dim() - 2) + 3)
                          + (8, 8))
    ph, pw = (-h) % 8, (-w) % 8
    dev = image.device
    x = image.index_select(-3, torch.arange(h + ph, device=dev).clamp(max=h - 1))
    x = x.index_select(-2, torch.arange(w + pw, device=dev).clamp(max=w - 1)) * 255.0 - 128.0
    hb, wb = (h + ph) // 8, (w + pw) // 8
    n = len(lead)
    # (..., hb, 8, wb, 8, c) -> (..., hb, wb, c, 8, 8)
    blocks = x.reshape(lead + (hb, 8, wb, 8, c)).permute(
        *range(n), n, n + 2, n + 4, n + 1, n + 3)
    d = _const(image, "dct8")
    coeff = d @ blocks @ d.T
    coeff = torch.round(coeff / table) * table
    out = d.T @ coeff @ d
    out = out.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2).reshape(
        lead + (hb * 8, wb * 8, c))
    return torch.clamp((out + 128.0) / 255.0, 0.0, 1.0)[..., :h, :w, :]
