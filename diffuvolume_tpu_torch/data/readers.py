"""File readers: PFM disparity, KITTI PNG/256 disparity, images.

Reference: SceneFlow/datasets/data_io.py:6-66 (PFM), KITTI15/core/utils/
frame_utils.py:124-128 (PNG/256).  Pure NumPy/PIL — no torch, no cv2
dependency for the core paths.  The port's own copy of
``diffuvolume_tpu/data/readers.py``.
"""

from __future__ import annotations

import re

import numpy as np
from PIL import Image


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Read a PFM file → (float32 array flipped to row-major top-down, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if dim_match is None:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.frombuffer(f.read(), endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)
        return np.ascontiguousarray(np.flipud(data)).astype(np.float32), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.flipud(image.astype(np.float32))
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        f.write(image.tobytes())


def read_kitti_disparity(path: str) -> np.ndarray:
    """KITTI uint16 PNG disparity: value/256, 0 = invalid
    (frame_utils.py:124-128)."""
    disp = np.asarray(Image.open(path), dtype=np.float32) / 256.0
    return disp


def read_image(path: str) -> np.ndarray:
    """RGB uint8 image → float32 (H, W, 3) in [0, 255]."""
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)


def read_all_lines(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo optical flow → (H, W, 2) float32
    (KITTI15/core/utils/frame_utils.py:13-32)."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != 202021.25:
            raise ValueError(f"Invalid .flo magic in {path}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(8 * w * h), np.float32)
        return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write a (H, W, 2) flow as Middlebury .flo (frame_utils.py:60-80)."""
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_disp_sintel(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Sintel split-channel PNG disparity + occlusion-mask validity
    (frame_utils.py:130-137): ``d = R*4 + G/64 + B/16384``; valid where the
    sibling ``occlusions`` mask is 0 and ``d > 0``."""
    a = np.asarray(Image.open(path), dtype=np.float32)
    disp = a[..., 0] * 4 + a[..., 1] / (2**6) + a[..., 2] / (2**14)
    mask = np.asarray(Image.open(path.replace("disparities", "occlusions")))
    valid = (mask == 0) & (disp > 0)
    return disp.astype(np.float32), valid


def read_disp_fallingthings(path: str) -> tuple[np.ndarray, np.ndarray]:
    """FallingThings depth PNG → disparity via the camera fx
    (frame_utils.py:139-146): ``d = fx * 6.0 * 100 / depth``."""
    import json
    import os

    a = np.asarray(Image.open(path), dtype=np.float32)
    with open(os.path.join(os.path.dirname(path), "_camera_settings.json")) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    with np.errstate(divide="ignore"):
        disp = (fx * 6.0 * 100) / a
    return disp.astype(np.float32), disp > 0


def read_disp_tartanair(path: str) -> tuple[np.ndarray, np.ndarray]:
    """TartanAir depth .npy → disparity ``80 / depth`` (frame_utils.py:149-153)."""
    depth = np.load(path)
    with np.errstate(divide="ignore"):
        disp = 80.0 / depth
    return disp.astype(np.float32), disp > 0


def read_gen(path: str):
    """Extension-dispatched generic reader (frame_utils.py:169-186)."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("png", "jpeg", "jpg", "ppm", "webp"):
        return read_image(path)
    if ext in ("bin", "raw", "npy"):
        return np.load(path)
    if ext == "flo":
        return read_flo(path)
    if ext == "pfm":
        data, _ = read_pfm(path)
        return data if data.ndim == 2 else data[:, :, :-1]
    raise ValueError(f"Unsupported extension: {path}")
