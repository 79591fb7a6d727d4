"""Training logger (the KITTI15 Logger, train_stereo.py:72-117).

The port's own copy of ``diffuvolume_tpu/utils/logger.py``: running-mean
console lines every ``print_freq`` steps, a ``metrics.jsonl`` stream (the
reference's TensorBoard scalars, machine-readable; a ``SummaryWriter`` is
attached as well when tensorboard imports), and image summaries.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class Logger:
    def __init__(self, logdir: str, print_freq: int = 100):
        self.logdir = logdir
        self.print_freq = print_freq
        self.step = 0
        self.running: dict[str, float] = {}
        self.t0 = time.time()
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.tb = None
        try:  # optional tensorboard
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(logdir)
        except Exception:
            pass

    def push(self, metrics: dict):
        self.step += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.step % self.print_freq == 0:
            means = {k: v / self.print_freq for k, v in self.running.items()}
            rate = self.print_freq / max(time.time() - self.t0, 1e-9)
            msg = ", ".join(f"{k} {v:.4f}" for k, v in means.items())
            print(f"[step {self.step}] {msg} ({rate:.2f} it/s)")
            self.jsonl.write(json.dumps({"step": self.step, **means}) + "\n")
            self.jsonl.flush()
            if self.tb is not None:
                for k, v in means.items():
                    self.tb.add_scalar(k, v, self.step)
            self.running = {}
            self.t0 = time.time()

    def write_images(self, images: dict, step: int | None = None):
        """Image summaries (SceneFlow/utils/experiment.py:72-88
        ``save_images``): each value ``(H, W)`` or ``(H, W, 3)`` float or
        uint8, min-max normalised per image (``make_grid(normalize=True,
        scale_each=True)``); to TensorBoard when it is attached, else PNGs
        under ``<logdir>/images/``."""
        step = self.step if step is None else step
        for tag, img in images.items():
            img = np.asarray(img)
            if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
                img = np.moveaxis(img, 0, -1)  # CHW → HWC
            img = img.astype(np.float32)
            lo, hi = float(img.min()), float(img.max())
            norm = (img - lo) / max(hi - lo, 1e-12)
            if self.tb is not None:
                chw = norm[None] if norm.ndim == 2 else np.moveaxis(norm, -1, 0)
                self.tb.add_image(tag, chw, step)
            else:
                from PIL import Image

                d = os.path.join(self.logdir, "images")
                os.makedirs(d, exist_ok=True)
                Image.fromarray((norm * 255).astype("uint8")).save(
                    os.path.join(d, f"{tag.replace('/', '_')}_{step}.png"))

    def write_dict(self, metrics: dict, step: int | None = None):
        step = self.step if step is None else step
        self.jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}})
                         + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
