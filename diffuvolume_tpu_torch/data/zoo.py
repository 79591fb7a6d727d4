"""Zero-shot / auxiliary dataset loaders and multi-dataset composition.

Reference: KITTI15/core/stereo_datasets.py:125-335 (glob-driven SceneFlow /
ETH3D / Middlebury / KITTI subclasses + fetch_dataloader composition) and the
KITTI12 zero-shot loaders (KITTI12/datasets/{MiddleburyLoader,eth3dLoader}.py).
The port's own copy of ``diffuvolume_tpu/data/zoo.py``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from diffuvolume_tpu_torch.data.readers import read_image, read_pfm
from diffuvolume_tpu_torch.data.sceneflow import SceneFlowDataset, normalize_image


class ETH3DDataset:
    """ETH3D two-view (stereo_datasets.py:191-201): PFM GT, glob-driven."""

    def __init__(self, datapath: str, split: str = "training"):
        self.samples = []
        img1 = sorted(glob.glob(os.path.join(datapath, f"two_view_{split}/*/im0.png")))
        img2 = sorted(glob.glob(os.path.join(datapath, f"two_view_{split}/*/im1.png")))
        disp = sorted(
            glob.glob(os.path.join(datapath, "two_view_training_gt/*/disp0GT.pfm"))
        )
        if split == "training":
            self.samples = list(zip(img1, img2, disp))
        else:
            self.samples = [(a, b, None) for a, b in zip(img1, img2)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        lf, rf, df = self.samples[i]
        out = {
            "left": normalize_image(read_image(lf)),
            "right": normalize_image(read_image(rf)),
            "filename": lf,
        }
        if df is not None:
            disp, _ = read_pfm(df)
            out["disp_gt"] = disp
            out["valid"] = (disp < 512) & (disp > 0)
            # The reference's ETH3D validation additionally restricts to the
            # non-occluded mask (evaluate_stereo.py:48-52: mask0nocc.png==255).
            nocc = df.replace("disp0GT.pfm", "mask0nocc.png")
            if os.path.exists(nocc):
                out["valid"] &= read_image(nocc)[..., 0] == 255
        return out


class MiddleburyDataset:
    """Middlebury-v3 (stereo_datasets.py:275-292): F/H/Q resolutions."""

    def __init__(self, datapath: str, split: str = "F"):
        if split not in ("F", "H", "Q"):
            raise ValueError(f"Middlebury split must be F, H or Q, got {split!r}")
        lefts = sorted(glob.glob(os.path.join(datapath, f"Mid{split}/*/im0.png"))) or sorted(
            glob.glob(os.path.join(datapath, "*/im0.png"))
        )
        self.samples = []
        for lf in lefts:
            rf = lf.replace("im0.png", "im1.png")
            df = lf.replace("im0.png", "disp0GT.pfm")
            if os.path.exists(rf):
                self.samples.append((lf, rf, df if os.path.exists(df) else None))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        lf, rf, df = self.samples[i]
        out = {
            "left": normalize_image(read_image(lf)),
            "right": normalize_image(read_image(rf)),
            "filename": lf,
        }
        if df is not None:
            disp, _ = read_pfm(df)
            disp = np.where(np.isfinite(disp), disp, 0.0).astype(np.float32)
            out["disp_gt"] = disp
            # Reference validity is the NON-OCCLUDED mask, not disp>0: pixels
            # where mask0nocc.png == 255 (readDispMiddlebury,
            # KITTI15/core/utils/frame_utils.py:156-165).  Fall back to
            # disp>0 only when the mask file is absent.
            nocc = df.replace("disp0GT.pfm", "mask0nocc.png")
            if os.path.exists(nocc):
                out["valid"] = (read_image(nocc)[..., 0] == 255) & (disp > 0)
            else:
                out["valid"] = disp > 0
        return out


class _GlobStereoDataset:
    """Shared glob-driven (left, right, disp-reader) dataset shape."""

    def __init__(self):
        self.samples: list[tuple[str, str, str]] = []

    def _read_disp(self, path):  # → (disp, valid)
        raise NotImplementedError

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        lf, rf, df = self.samples[i]
        disp, valid = self._read_disp(df)
        return {
            "left": normalize_image(read_image(lf)),
            "right": normalize_image(read_image(rf)),
            "disp_gt": disp,
            "valid": valid,
            "filename": lf,
        }


class SintelStereoDataset(_GlobStereoDataset):
    """MPI-Sintel stereo (stereo_datasets.py:203-214): clean+final passes,
    split-channel PNG disparity with occlusion-mask validity (sparse)."""

    def __init__(self, datapath: str):
        super().__init__()
        img1 = sorted(glob.glob(os.path.join(datapath, "training/*_left/*/frame_*.png")))
        img2 = sorted(glob.glob(os.path.join(datapath, "training/*_right/*/frame_*.png")))
        disp = sorted(glob.glob(os.path.join(datapath, "training/disparities/*/frame_*.png"))) * 2
        for a, b, d in zip(img1, img2, disp):
            if a.split(os.sep)[-2:] != d.split(os.sep)[-2:]:
                raise ValueError(f"image and disparity lists disagree: {a}, {d}")
            self.samples.append((a, b, d))

    def _read_disp(self, path):
        from diffuvolume_tpu_torch.data.readers import read_disp_sintel

        return read_disp_sintel(path)


class FallingThingsDataset(_GlobStereoDataset):
    """FallingThings (stereo_datasets.py:216-230): manifest-driven, depth PNG →
    disparity via camera fx."""

    def __init__(self, datapath: str):
        super().__init__()
        with open(os.path.join(datapath, "filenames.txt")) as f:
            names = sorted(line.strip() for line in f if line.strip())
        for e in names:
            self.samples.append(
                (
                    os.path.join(datapath, e),
                    os.path.join(datapath, e.replace("left.jpg", "right.jpg")),
                    os.path.join(datapath, e.replace("left.jpg", "left.depth.png")),
                )
            )

    def _read_disp(self, path):
        from diffuvolume_tpu_torch.data.readers import read_disp_fallingthings

        return read_disp_fallingthings(path)


class TartanAirDataset(_GlobStereoDataset):
    """TartanAir (stereo_datasets.py:232-248): manifest-driven with keyword
    filters, depth .npy → disparity 80/depth."""

    def __init__(self, datapath: str, keywords: tuple[str, ...] = ()):
        super().__init__()
        with open(os.path.join(datapath, "tartanair_filenames.txt")) as f:
            names = sorted(
                s.strip()
                for s in f
                if s.strip() and "seasonsforest_winter/Easy" not in s
            )
        for kw in keywords:
            names = [s for s in names if kw in s.lower()]
        for e in names:
            self.samples.append(
                (
                    os.path.join(datapath, e),
                    os.path.join(datapath, e.replace("_left", "_right")),
                    os.path.join(
                        datapath,
                        e.replace("image_left", "depth_left").replace(
                            "left.png", "left_depth.npy"
                        ),
                    ),
                )
            )

    def _read_disp(self, path):
        from diffuvolume_tpu_torch.data.readers import read_disp_tartanair

        return read_disp_tartanair(path)


class ConcatDataset:
    """Weighted concatenation (the reference's ``__mul__`` dataset repetition
    + ``+`` composition, stereo_datasets.py:112-122,295-335)."""

    def __init__(self, datasets_with_repeats):
        self.parts = []
        for ds, rep in datasets_with_repeats:
            for _ in range(rep):
                self.parts.append(ds)
        self.lengths = [len(d) for d in self.parts]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, i):
        for d, n in zip(self.parts, self.lengths):
            if i < n:
                return d[i]
            i -= n
        raise IndexError


def fetch_dataset(name: str, datapath: str, training: bool = False, **kw):
    """Name-driven dataset factory (stereo_datasets.py:295-335 simplified)."""
    from diffuvolume_tpu_torch.data.kitti import KITTIDataset

    if name == "sceneflow":
        return SceneFlowDataset(datapath, training=training, **kw)
    if name in ("kitti12", "kitti15", "kitti", "kitti1215"):
        # 'kitti1215' = the reference's combined-finetune loader
        # (SceneFlow/datasets/kitti_dataset_1215.py) — same list-file protocol
        # with entries spanning both datasets.
        return KITTIDataset(datapath, training=training, **kw)
    if name == "eth3d":
        return ETH3DDataset(datapath, **kw)
    if name == "sintel":
        return SintelStereoDataset(datapath)
    if name == "fallingthings":
        return FallingThingsDataset(datapath)
    if name == "tartanair":
        return TartanAirDataset(datapath, **kw)
    if name.startswith("middlebury"):
        return MiddleburyDataset(datapath, split=name[-1].upper() if name[-1] in "FHQfhq" else "F")
    raise KeyError(name)
