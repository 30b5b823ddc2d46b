"""Metrics logging (reference `Summary`, rl/utils.py:577-673, and
`IncrementalStatistics`, rl/utils.py:676-720).

A copy of carla_driving_rl_agent_tpu/utils/summary.py (numpy host code;
the port imports nothing of the JAX package).  Modes, as the reference's:
  'summary' — buffered values flushed to JSONL event files under
              <log_dir>/<name>/<timestamp>/events.jsonl (default log_dir
              logs/), made at the first flush, and to a TensorBoard writer
              when torch.utils.tensorboard imports
  'log'     — kept in memory (self.history)
  None      — disabled (the evaluation's, reference core/learning.py:509)
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Iterable, Optional

import numpy as np


class Summary:
    def __init__(self, mode: str = "summary", name: Optional[str] = None,
                 log_dir: str = "logs", summary_keys: Optional[Iterable[str]] = None):
        self.mode = mode
        self.buffer = defaultdict(list)
        self.history = defaultdict(list)
        self.keys = set(summary_keys) if summary_keys else None
        self.step = 0
        self._writer = None
        self._tb = None
        if mode == "summary":
            stamp = time.strftime("%Y%m%d-%H%M%S")
            self.dir = os.path.join(log_dir, name or "run", stamp)
            self._path = os.path.join(self.dir, "events.jsonl")

    def _open(self) -> None:
        """Make the run's directory and the optional TensorBoard writer at
        the first write (the JAX package makes them at construction: here an
        agent that never writes a summary leaves nothing on disk)."""
        if self._writer is not None:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._writer = self._path
        try:  # optional: torch.utils.tensorboard needs the tensorboard package
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(self.dir)
        except Exception:
            self._tb = None

    def should_log(self, key: str) -> bool:
        return self.keys is None or key in self.keys

    def log(self, **kwargs):
        """Buffer values (reference `Summary.add` semantics)."""
        if self.mode is None:
            return
        for k, v in kwargs.items():
            if not self.should_log(k):
                continue
            v = np.asarray(v)
            if self.mode == "log":
                self.history[k].append(v.tolist())
            else:
                self.buffer[k].append(v)

    def write_summaries(self):
        """Flush buffered values — reference `rl/utils.py:631-659` routing:
        'weight-'/'bias-' keys become histograms, 'image_' keys become image
        summaries, everything else scalar means.  Histograms are decile
        records in the JSONL stream (+ tensorboard add_histogram when
        available); images go to PNG files under <dir>/images (+ tensorboard
        add_images)."""
        if self.mode != "summary" or not self.buffer:
            self.buffer.clear()
            return
        self._open()
        record = {"step": self.step, "time": time.time()}
        for k, vals in self.buffer.items():
            if "weight-" in k or "bias-" in k:
                flat = np.concatenate(
                    [np.ravel(np.asarray(v, np.float64)) for v in vals])
                qs = np.percentile(flat, [0, 10, 25, 50, 75, 90, 100])
                record[f"{k}_hist"] = dict(
                    quantiles=[float(q) for q in qs],
                    mean=float(flat.mean()), std=float(flat.std()),
                    count=int(flat.size))
                if self._tb is not None:
                    self._tb.add_histogram(k, flat, self.step)
                continue
            if "image_" in k:
                imgs = np.concatenate(
                    [np.asarray(v) if np.asarray(v).ndim == 4
                     else np.asarray(v)[None] for v in vals], axis=0)
                record[f"{k}_images"] = self._write_images(k, imgs)
                if self._tb is not None:
                    chw = np.transpose(imgs, (0, 3, 1, 2))
                    self._tb.add_images(k, chw, self.step)
                continue
            flat = np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in vals])
            record[k] = float(np.mean(flat))
            if flat.size > 1:
                record[f"{k}_std"] = float(np.std(flat))
            if self._tb is not None:
                self._tb.add_scalar(k, record[k], self.step)
        with open(self._path, "a") as f:
            f.write(json.dumps(record) + "\n")
        self.buffer.clear()
        self.step += 1

    def _write_images(self, key: str, imgs: np.ndarray) -> list:
        """Save a (N, H, W, C) image batch as PNGs; returns relative paths."""
        img_dir = os.path.join(self.dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        paths = []
        for i, img in enumerate(imgs[:16]):   # bound the disk cost
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            name = f"{key}-{self.step}-{i}.png"
            _write_png(os.path.join(img_dir, name), arr)
            paths.append(os.path.join("images", name))
        return paths


def _write_png(path: str, arr: np.ndarray) -> None:
    """Minimal dependency-free PNG writer (8-bit gray/RGB/RGBA)."""
    import struct
    import zlib
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


# ------------------------------------------------------------------
# Plot helpers (reference rl/utils.py:158-182 + Summary.plot :661-673);
# matplotlib is optional: it is imported at call time, not import time
# ------------------------------------------------------------------

def plot_images(images: list, show: bool = True, path: Optional[str] = None):
    """Arrange a list of images in a near-square grid
    (reference `plot_images`, rl/utils.py:158-170)."""
    import math
    import matplotlib.pyplot as plt
    n = len(images)
    rows = round(math.sqrt(n))
    cols = math.ceil(n / max(rows, 1))
    for k, img in enumerate(images):
        plt.subplot(rows, cols, k + 1)
        plt.axis("off")
        plt.imshow(np.asarray(img))
    plt.subplots_adjust(wspace=0, hspace=0)
    if path:
        plt.savefig(path, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close()


def plot_parameter(schedule, iterations: int, initial_step: int = 0,
                   show: bool = True, path: Optional[str] = None):
    """Plot a dynamic parameter / LR schedule over `iterations` steps
    (reference `plot_lr_schedule`, rl/utils.py:173-182)."""
    import matplotlib.pyplot as plt
    vals = []
    for i in range(iterations):
        v = schedule(step=i + initial_step) if callable(schedule) else schedule
        vals.append(float(v))
    plt.plot(vals)
    if path:
        plt.savefig(path, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close()


def plot_summary(history: dict, colormap: str = "Set3", show: bool = True,
                 path: Optional[str] = None):
    """Grid-plot a {key: [values]} history (reference `Summary.plot`,
    rl/utils.py:661-673)."""
    import math
    import matplotlib.pyplot as plt
    n = max(len(history), 1)
    cmap = plt.get_cmap(colormap)
    rows = round(math.sqrt(n))
    cols = math.ceil(n / max(rows, 1))
    for k, (key, value) in enumerate(history.items()):
        plt.subplot(rows, cols, k + 1)
        plt.plot(np.asarray(value, np.float64), color=cmap(k + 1))
        plt.title(key)
    if path:
        plt.savefig(path, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close()


class IncrementalStatistics:
    """Running mean/variance/std via Welford updates
    (reference `rl/utils.py:676-720`)."""

    def __init__(self, epsilon: float = 1e-8):
        self.mean = 0.0
        self.variance = 0.0
        self.std = 0.0
        self.count = 0
        self.eps = epsilon

    def update(self, value):
        values = np.ravel(np.asarray(value, np.float64))
        for v in values:
            self.count += 1
            delta = v - self.mean
            self.mean += delta / self.count
            self.variance += delta * (v - self.mean)
        self.std = float(np.sqrt(self.variance / max(self.count, 1)) + self.eps)

    def normalize(self, value):
        return (np.asarray(value) - self.mean) / (self.std + self.eps)

    def set(self, mean: float, std: float, count: int = 1):
        self.mean, self.std, self.count = mean, std, count

    def as_dict(self) -> dict:
        return dict(mean=float(self.mean), std=float(self.std),
                    variance=float(self.variance), count=int(self.count))
