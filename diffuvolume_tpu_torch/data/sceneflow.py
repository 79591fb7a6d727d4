"""SceneFlow dataset + batching pipeline (NumPy host-side, device-agnostic).

Reference: SceneFlow/datasets/sceneflow_dataset.py:9-76 — file-list driven;
train = random 512×256 crop + ImageNet normalization; test = fixed bottom-right
960×512 crop.  Without a file list the (left, right, disparity) triplets
are found by globbing the tree, as the reference's KITTI15 loader does
(stereo_datasets.py:144-146).

The port's own copy of ``diffuvolume_tpu/data/sceneflow.py`` (numpy only).
Batches are channels-last float32 numpy dicts; ``data/loader.py`` moves
them to the card.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from diffuvolume_tpu_torch.data.readers import read_all_lines, read_image, read_pfm

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8-range (H,W,3) → ImageNet-normalized float32 (data_io.py:20-30)."""
    return (img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class SceneFlowDataset:
    """File-list driven SceneFlow loader producing channels-last samples."""

    TRAIN_CROP = (256, 512)  # (H, W)
    TEST_CROP = (512, 960)

    def __init__(
        self,
        datapath: str,
        list_filename: str | None = None,
        training: bool = False,
        seed: int = 0,
    ):
        self.datapath = datapath
        self.training = training
        self.rng = np.random.default_rng(seed)
        if list_filename is not None and os.path.exists(list_filename):
            lines = [l.split() for l in read_all_lines(list_filename)]
            self.samples = [(l[0], l[1], l[2]) for l in lines]
        else:
            self.samples = self._glob_manifest(datapath)

    @staticmethod
    def _glob_manifest(datapath: str) -> list[tuple[str, str, str]]:
        """Regenerate (left, right, disp) triplets by globbing the tree."""
        out = []
        for left in sorted(
            glob.glob(os.path.join(datapath, "**", "left", "*.png"), recursive=True)
        ):
            right = left.replace("/left/", "/right/")
            disp = (
                left.replace("frames_finalpass", "disparity")
                .replace("frames_cleanpass", "disparity")
                .replace(".png", ".pfm")
            )
            if os.path.exists(right) and os.path.exists(disp):
                out.append(
                    tuple(os.path.relpath(p, datapath) for p in (left, right, disp))
                )
        return out

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        lf, rf, df = self.samples[index]
        left = read_image(os.path.join(self.datapath, lf))
        right = read_image(os.path.join(self.datapath, rf))
        disp, _ = read_pfm(os.path.join(self.datapath, df))
        if disp.ndim == 3:
            disp = disp[..., 0]

        h, w = disp.shape
        if self.training:
            ch, cw = self.TRAIN_CROP
            x1 = int(self.rng.integers(0, w - cw + 1))
            y1 = int(self.rng.integers(0, h - ch + 1))
        else:
            ch, cw = self.TEST_CROP
            x1, y1 = w - cw, h - ch
        sl = np.s_[y1 : y1 + ch, x1 : x1 + cw]
        return {
            "left": normalize_image(left[sl]),
            "right": normalize_image(right[sl]),
            "disp_gt": np.ascontiguousarray(disp[sl]),
            "filename": lf,
        }

    def batches(self, batch_size: int, shuffle: bool | None = None):
        """Yield stacked batch dicts (drops the ragged tail when training)."""
        shuffle = self.training if shuffle is None else shuffle
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(j)] for j in order[i : i + batch_size]]
            yield {
                "left": np.stack([it["left"] for it in items]),
                "right": np.stack([it["right"] for it in items]),
                "disp_gt": np.stack([it["disp_gt"] for it in items]),
                "filenames": [it["filename"] for it in items],
            }
