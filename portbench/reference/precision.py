"""The float32 precision that the reference computes in, and the lower
precision of the control: TF32 in the matrix products and convolutions,
the nearest precision below the configuration's float32 with TF32 off."""

from __future__ import annotations

import contextlib

import torch


def _set(tf32: bool) -> tuple:
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return prev


@contextlib.contextmanager
def mode(name: str):
    """"float32" (TF32 off) or "tf32" within the block."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    prev = _set(name == "tf32")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
