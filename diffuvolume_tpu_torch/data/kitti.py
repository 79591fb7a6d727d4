"""KITTI 2012/2015 datasets (train jitter+crop+occlusion; test pad-to-1248×384).

Reference: KITTI12/datasets/kitti_dataset.py:11-146 and the KITTI15 loaders in
KITTI15/core/stereo_datasets.py:250-272.  Disparity PNGs are uint16/256 with
0 = invalid.  The port's own copy of ``diffuvolume_tpu/data/kitti.py``.
"""

from __future__ import annotations

import os

import numpy as np

from diffuvolume_tpu_torch.data.augment import (
    occlusion_patch,
    photometric_jitter,
    random_crop,
)
from diffuvolume_tpu_torch.data.readers import (
    read_all_lines,
    read_image,
    read_kitti_disparity,
)
from diffuvolume_tpu_torch.data.sceneflow import normalize_image


class KITTIDataset:
    """KITTI 2012 / 2015 stereo loader (list-file driven)."""

    TRAIN_CROP = (256, 512)
    TEST_PAD = (384, 1248)  # (H, W): pad top / right (kitti_dataset.py:120-127)

    def __init__(
        self, datapath: str, list_filename: str, training: bool = False, seed: int = 0
    ):
        self.datapath = datapath
        self.training = training
        self.rng = np.random.default_rng(seed)
        lines = [l.split() for l in read_all_lines(list_filename)]
        self.left_files = [l[0] for l in lines]
        self.right_files = [l[1] for l in lines]
        self.disp_files = [l[2] for l in lines] if len(lines[0]) > 2 else None
        if training and self.disp_files is None:
            raise ValueError(f"{list_filename} lists no disparity files to train on")

    def __len__(self):
        return len(self.left_files)

    def __getitem__(self, index: int) -> dict:
        left = read_image(os.path.join(self.datapath, self.left_files[index]))
        right = read_image(os.path.join(self.datapath, self.right_files[index]))
        disp = (
            read_kitti_disparity(os.path.join(self.datapath, self.disp_files[index]))
            if self.disp_files
            else None
        )

        if self.training:
            left = photometric_jitter(left, self.rng)
            right = photometric_jitter(right, self.rng)
            left, right, disp = random_crop([left, right, disp], self.TRAIN_CROP, self.rng)
            right = occlusion_patch(right, self.rng, p=0.2)
            return {
                "left": normalize_image(left).astype(np.float32),
                "right": normalize_image(right).astype(np.float32),
                "disp_gt": np.ascontiguousarray(disp, np.float32),
            }

        h, w = left.shape[:2]
        top_pad = self.TEST_PAD[0] - h
        right_pad = self.TEST_PAD[1] - w
        if top_pad < 0 or right_pad < 0:
            raise ValueError(f"image {(h, w)} is larger than the test pad {self.TEST_PAD}")
        pad_img = lambda x: np.pad(x, ((top_pad, 0), (0, right_pad), (0, 0)))
        out = {
            "left": normalize_image(pad_img(left)).astype(np.float32),
            "right": normalize_image(pad_img(right)).astype(np.float32),
            "top_pad": top_pad,
            "right_pad": right_pad,
            "filename": self.left_files[index],
        }
        if disp is not None:
            out["disp_gt"] = np.pad(disp, ((top_pad, 0), (0, right_pad))).astype(np.float32)
        return out

    def batches(self, batch_size: int, shuffle: bool | None = None):
        shuffle = self.training if shuffle is None else shuffle
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(j)] for j in order[i : i + batch_size]]
            batch = {
                k: np.stack([it[k] for it in items])
                for k in ("left", "right")
            }
            if "disp_gt" in items[0]:
                batch["disp_gt"] = np.stack([it["disp_gt"] for it in items])
            if "filename" in items[0]:
                batch["filenames"] = [it["filename"] for it in items]
            yield batch
