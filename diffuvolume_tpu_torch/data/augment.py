"""Host-side photometric / geometric augmentation (NumPy; no torch/cv2).

Covers the KITTI12 recipe (KITTI12/datasets/kitti_dataset.py:54-101): per-eye
brightness/gamma/contrast jitter, random crop, 20%-probability right-image
mean-fill occlusion patch; and the full KITTI15/RAFT augmentor
(KITTI15/core/utils/augmentor.py:60-314): torchvision-equivalent ColorJitter
(random op order, brightness/contrast/saturation/hue) with the asymmetric
p=0.2 split, eraser occlusion, per-axis stretch schedule, h/hf/v flip modes,
y-jittered crop, and sparse disparity re-scatter — see FlowAugmentor /
SparseFlowAugmentor.  The port's own copy of
``diffuvolume_tpu/data/augment.py``.
"""

from __future__ import annotations

import numpy as np


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """torchvision adjust_brightness: img * factor, clipped (uint8-range floats)."""
    return np.clip(img * factor, 0, 255)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    """torchvision adjust_gamma: 255 * gain * (img/255)^gamma."""
    return np.clip(255.0 * gain * (img / 255.0) ** gamma, 0, 255)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """torchvision adjust_contrast: blend with the mean of the grayscale image."""
    gray_mean = (img @ np.asarray([0.299, 0.587, 0.114], img.dtype)).mean()
    return np.clip(gray_mean + factor * (img - gray_mean), 0, 255)


def photometric_jitter(
    img: np.ndarray, rng: np.random.Generator,
    brightness=(0.5, 2.0), gamma=(0.8, 1.2), contrast=(0.8, 1.2),
) -> np.ndarray:
    """KITTI12 per-eye jitter chain (kitti_dataset.py:54-62)."""
    img = adjust_brightness(img, rng.uniform(*brightness))
    img = adjust_gamma(img, rng.uniform(*gamma))
    img = adjust_contrast(img, rng.uniform(*contrast))
    return img


def random_crop(
    arrays: list[np.ndarray], crop_hw: tuple[int, int], rng: np.random.Generator
) -> list[np.ndarray]:
    """Joint random crop (flow_transforms.RandomCrop)."""
    h, w = arrays[0].shape[:2]
    ch, cw = crop_hw
    y = int(rng.integers(0, h - ch + 1))
    x = int(rng.integers(0, w - cw + 1))
    return [a[y : y + ch, x : x + cw] for a in arrays]


def scale_co_transform(
    left: np.ndarray, right: np.ndarray, disp: np.ndarray, ratio: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Joint rescale of a stereo pair and its disparity (×ratio).

    Reference: KITTI12/datasets/flow_transforms.py:24-47 (``Scale`` — dormant;
    commented out at every call site).  Disparity values scale with the ratio.
    """
    import cv2

    left = cv2.resize(left, None, fx=ratio, fy=ratio, interpolation=cv2.INTER_CUBIC)
    right = cv2.resize(right, None, fx=ratio, fy=ratio, interpolation=cv2.INTER_CUBIC)
    disp = cv2.resize(disp, None, fx=ratio, fy=ratio, interpolation=cv2.INTER_CUBIC) * ratio
    return left, right, disp


def random_vdisp(
    right: np.ndarray, rng: np.random.Generator, angle: float = 0.05, px: float = 1.0
) -> np.ndarray:
    """Vertical-disparity asymmetry: small random rotation + y-shift of the
    right image only.

    Reference: KITTI12/datasets/flow_transforms.py:73-93 (``RandomVdisp`` —
    dormant hook, kitti_dataset.py:79-90).
    """
    import cv2

    px2 = rng.uniform(-px, px)
    angle2 = rng.uniform(-angle, angle)
    center = (rng.uniform(0, right.shape[0]), rng.uniform(0, right.shape[1]))
    rot = cv2.getRotationMatrix2D(center, angle2, 1.0)
    out = cv2.warpAffine(right, rot, right.shape[1::-1], flags=cv2.INTER_LINEAR)
    trans = np.float32([[1, 0, 0], [0, 1, px2]])
    return cv2.warpAffine(out, trans, right.shape[1::-1], flags=cv2.INTER_LINEAR)


def occlusion_patch(right: np.ndarray, rng: np.random.Generator, p: float = 0.2) -> np.ndarray:
    """Right-image mean-fill rectangle (kitti_dataset.py:96-101)."""
    if rng.uniform() >= p:
        return right
    sx = int(rng.uniform(35, 100))
    sy = int(rng.uniform(25, 75))
    if right.shape[0] <= 2 * sx or right.shape[1] <= 2 * sy:
        return right
    cx = int(rng.uniform(sx, right.shape[0] - sx))
    cy = int(rng.uniform(sy, right.shape[1] - sy))
    out = right.copy()
    out[cx - sx : cx + sx, cy - sy : cy + sy] = right.mean(axis=(0, 1), keepdims=True)
    return out


def _bilinear_resize_np(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2-free bilinear resize (align_corners=False half-pixel sampling)."""
    h, w = img.shape[:2]
    h1, w1 = int(round(h * fy)), int(round(w * fx))
    ys = np.clip((np.arange(h1) + 0.5) * (h / h1) - 0.5, 0, h - 1)
    xs = np.clip((np.arange(w1) + 0.5) * (w / w1) - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img[..., None] if img.ndim == 2 else img
    out = (
        img[y0][:, x0] * (1 - wy) * (1 - wx)
        + img[y0][:, x1] * (1 - wy) * wx
        + img[y1][:, x0] * wy * (1 - wx)
        + img[y1][:, x1] * wy * wx
    )
    return out[..., 0] if out.shape[-1] == 1 else out


def resize_sparse_disparity(
    disp: np.ndarray, valid: np.ndarray, fx: float, fy: float
) -> tuple[np.ndarray, np.ndarray]:
    """Re-scatter valid sparse disparity points after scaling
    (KITTI15/core/utils/augmentor.py:224-256)."""
    h, w = disp.shape
    ys, xs = np.nonzero(valid >= 1)
    d0 = disp[ys, xs]
    h1, w1 = int(round(h * fy)), int(round(w * fx))
    xx = np.round(xs * fx).astype(np.int32)
    yy = np.round(ys * fy).astype(np.int32)
    d1 = d0 * fx
    keep = (xx > 0) & (xx < w1) & (yy > 0) & (yy < h1)
    out_d = np.zeros((h1, w1), np.float32)
    out_v = np.zeros((h1, w1), np.float32)
    out_d[yy[keep], xx[keep]] = d1[keep]
    out_v[yy[keep], xx[keep]] = 1.0
    return out_d, out_v


def sparse_spatial_transform(
    img1: np.ndarray, img2: np.ndarray, disp: np.ndarray, valid: np.ndarray,
    crop_size: tuple[int, int], rng: np.random.Generator,
    min_scale: float = -0.2, max_scale: float = 0.4,
    spatial_aug_prob: float = 0.8,
):
    """RAFT-style sparse spatial augmentation (augmentor.py:258-305 without
    flips, which the KITTI recipe disables): random 2^U(min,max) rescale with
    sparse disparity re-scatter, then margin-jittered crop."""
    ht, wd = img1.shape[:2]
    min_s = max((crop_size[0] + 1) / ht, (crop_size[1] + 1) / wd)
    scale = 2.0 ** rng.uniform(min_scale, max_scale)
    s = max(scale, min_s)
    if rng.uniform() < spatial_aug_prob or min_s > 1.0:
        img1 = _bilinear_resize_np(img1, s, s)
        img2 = _bilinear_resize_np(img2, s, s)
        disp, valid = resize_sparse_disparity(disp, valid, s, s)
    margin_y, margin_x = 20, 50
    y0 = int(rng.integers(0, img1.shape[0] - crop_size[0] + margin_y))
    x0 = int(rng.integers(-margin_x, img1.shape[1] - crop_size[1] + margin_x))
    y0 = int(np.clip(y0, 0, img1.shape[0] - crop_size[0]))
    x0 = int(np.clip(x0, 0, img1.shape[1] - crop_size[1]))
    sl = np.s_[y0 : y0 + crop_size[0], x0 : x0 + crop_size[1]]
    return img1[sl], img2[sl], disp[sl], valid[sl]


def eraser_transform(
    right: np.ndarray, rng: np.random.Generator, p: float = 0.5, max_boxes: int = 2,
    bounds: tuple[int, int] = (50, 100),
) -> np.ndarray:
    """RAFT eraser occlusion (augmentor.py:84-95): mean-color random boxes."""
    if rng.uniform() >= p:
        return right
    h, w = right.shape[:2]
    out = right.copy()
    mean_color = right.reshape(-1, right.shape[-1]).mean(0)
    for _ in range(int(rng.integers(1, max_boxes + 1))):
        x0 = int(rng.integers(0, w))
        y0 = int(rng.integers(0, h))
        dx = int(rng.integers(bounds[0], bounds[1]))
        dy = int(rng.integers(bounds[0], bounds[1]))
        out[y0 : y0 + dy, x0 : x0 + dx] = mean_color
    return out


# ---------------------------------------------------------------------------
# torchvision-equivalent ColorJitter (NumPy)
# ---------------------------------------------------------------------------

_GRAY_W = np.asarray([0.299, 0.587, 0.114], np.float32)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """torchvision adjust_saturation: blend with the per-pixel grayscale."""
    gray = img @ _GRAY_W
    return np.clip(gray[..., None] + factor * (img - gray[..., None]), 0, 255)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """torchvision adjust_hue: shift H by ``factor`` (of a full turn) in HSV.

    ``factor`` ∈ [-0.5, 0.5].  Pure-NumPy RGB↔HSV round trip.
    """
    x = np.clip(img, 0, 255).astype(np.float32) / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    rng_c = maxc - minc
    s = np.where(maxc > 0, rng_c / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(rng_c, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = np.where(rng_c == 0, 0.0, (h / 6.0) % 1.0)

    h = (h + factor) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.clip(np.stack([r2, g2, b2], -1) * 255.0, 0, 255)


class ColorJitterNP:
    """torchvision.transforms.ColorJitter equivalent on float [0,255] arrays.

    Matches the sampling contract (transforms.py ColorJitter.get_params):
    factor ~ U(max(0, 1-x), 1+x) for brightness/contrast/saturation (or the
    explicit (lo, hi) range), hue ~ U(-h, h), applied in a RANDOM permutation
    order.  Optionally chains AdjustGamma (augmentor.py:47-56).
    """

    def __init__(self, brightness=0.4, contrast=0.4, saturation=(0.6, 1.4),
                 hue=0.5 / 3.14, gamma=(1.0, 1.0, 1.0, 1.0)):
        def rng_of(x):
            if isinstance(x, (tuple, list)):
                return tuple(x)
            return (max(0.0, 1.0 - x), 1.0 + x)

        self.brightness = rng_of(brightness)
        self.contrast = rng_of(contrast)
        self.saturation = rng_of(saturation)
        self.hue = (-hue, hue) if not isinstance(hue, (tuple, list)) else tuple(hue)
        self.gamma = gamma  # (gamma_min, gamma_max, gain_min, gain_max)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        fb = rng.uniform(*self.brightness)
        fc = rng.uniform(*self.contrast)
        fs = rng.uniform(*self.saturation)
        fh = rng.uniform(*self.hue)
        ops = [
            lambda x: adjust_brightness(x, fb),
            lambda x: adjust_contrast(x, fc),
            lambda x: adjust_saturation(x, fs),
            lambda x: adjust_hue(x, fh),
        ]
        for idx in rng.permutation(4):
            img = ops[idx](img)
        gmin, gmax, gain_min, gain_max = (*self.gamma, 1.0, 1.0)[:4]
        if (gmin, gmax) != (1.0, 1.0) or (gain_min, gain_max) != (1.0, 1.0):
            img = adjust_gamma(img, rng.uniform(gmin, gmax),
                               rng.uniform(gain_min, gain_max))
        return img


# ---------------------------------------------------------------------------
# Full KITTI15/RAFT augmentors (augmentor.py:60-314)
# ---------------------------------------------------------------------------


def _apply_flips(img1, img2, disp, valid, rng, do_flip,
                 h_flip_prob=0.5, v_flip_prob=0.1):
    """The reference's three flip modes (augmentor.py:138-152, 283-296).

    ``disp`` here is positive disparity (the reference stores flow whose x
    component is -disp; its 'hf' mode multiplies flow_x by -1, which on
    positive disparities is sign-preserving — disp stays positive).
    """
    if not do_flip:
        return img1, img2, disp, valid
    if rng.uniform() < h_flip_prob and do_flip == "hf":  # h-flip both + disp
        img1 = img1[:, ::-1]
        img2 = img2[:, ::-1]
        disp = disp[:, ::-1]
        if valid is not None:
            valid = valid[:, ::-1]
    if rng.uniform() < h_flip_prob and do_flip == "h":  # stereo eye swap
        img1, img2 = img2[:, ::-1], img1[:, ::-1]
    if rng.uniform() < v_flip_prob and do_flip == "v":
        img1 = img1[::-1, :]
        img2 = img2[::-1, :]
        disp = disp[::-1, :]
        if valid is not None:
            valid = valid[::-1, :]
    return img1, img2, disp, valid


class FlowAugmentor:
    """Dense-GT augmentor (SceneFlow recipe; augmentor.py:60-185).

    Pipeline: asymmetric-p=0.2 color jitter → eraser → scale (with per-axis
    stretch, p=0.8) → flips → (y-jittered) crop.
    """

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 yjitter=False, saturation_range=(0.6, 1.4),
                 gamma=(1.0, 1.0, 1.0, 1.0)):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = ColorJitterNP(0.4, 0.4, saturation_range, 0.5 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        if rng.uniform() < self.asymmetric_color_aug_prob:
            return self.photo(img1, rng), self.photo(img2, rng)
        # Symmetric: ONE factor draw applied to the stacked pair.
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo(stack, rng)
        return np.split(stack, 2, axis=0)

    def spatial_transform(self, img1, img2, disp, rng):
        ht, wd = img1.shape[:2]
        min_s = max((self.crop_size[0] + 8) / ht, (self.crop_size[1] + 8) / wd)
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.uniform() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx = max(sx, min_s)
        sy = max(sy, min_s)
        if rng.uniform() < self.spatial_aug_prob:
            img1 = _bilinear_resize_np(img1, sx, sy)
            img2 = _bilinear_resize_np(img2, sx, sy)
            # disparity is the -x flow component: scales with sx.
            disp = _bilinear_resize_np(disp, sx, sy) * sx

        img1, img2, disp, _ = _apply_flips(
            img1, img2, disp, None, rng, self.do_flip,
            self.h_flip_prob, self.v_flip_prob,
        )

        ch, cw = self.crop_size
        if self.yjitter:  # augmentor.py:154-162
            y0 = int(rng.integers(2, img1.shape[0] - ch - 2))
            x0 = int(rng.integers(2, img1.shape[1] - cw - 2))
            y1 = y0 + int(rng.integers(-2, 3))
            img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
            img2 = img2[y1 : y1 + ch, x0 : x0 + cw]
            disp = disp[y0 : y0 + ch, x0 : x0 + cw]
        else:
            y0 = int(rng.integers(0, img1.shape[0] - ch))
            x0 = int(rng.integers(0, img1.shape[1] - cw))
            img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
            img2 = img2[y0 : y0 + ch, x0 : x0 + cw]
            disp = disp[y0 : y0 + ch, x0 : x0 + cw]
        return img1, img2, disp

    def __call__(self, img1, img2, disp, rng: np.random.Generator):
        img1, img2 = self.color_transform(img1, img2, rng)
        img2 = eraser_transform(img2, rng, p=self.eraser_aug_prob)
        img1, img2, disp = self.spatial_transform(img1, img2, disp, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(disp))


class SparseFlowAugmentor:
    """Sparse-GT augmentor (KITTI recipe; augmentor.py:187-314).

    Differences from FlowAugmentor, per the reference: always-symmetric color
    (milder jitter, hue 0.3/3.14), spatial_aug_prob=0.8, NO stretch applied
    (scale_x = scale_y = clip(scale)), sparse re-scatter of the disparity,
    margin-jittered crop, no y-jitter.
    """

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 yjitter=False, saturation_range=(0.7, 1.3),
                 gamma=(1.0, 1.0, 1.0, 1.0)):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = ColorJitterNP(0.3, 0.3, saturation_range, 0.3 / 3.14, gamma)
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo(stack, rng)
        return np.split(stack, 2, axis=0)

    def spatial_transform(self, img1, img2, disp, valid, rng):
        ht, wd = img1.shape[:2]
        min_s = max((self.crop_size[0] + 1) / ht, (self.crop_size[1] + 1) / wd)
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        s = max(scale, min_s)
        if rng.uniform() < self.spatial_aug_prob:
            img1 = _bilinear_resize_np(img1, s, s)
            img2 = _bilinear_resize_np(img2, s, s)
            disp, valid = resize_sparse_disparity(disp, valid, s, s)

        img1, img2, disp, valid = _apply_flips(
            img1, img2, disp, valid, rng, self.do_flip,
            self.h_flip_prob, self.v_flip_prob,
        )

        ch, cw = self.crop_size
        margin_y, margin_x = 20, 50
        y0 = int(rng.integers(0, img1.shape[0] - ch + margin_y))
        x0 = int(rng.integers(-margin_x, img1.shape[1] - cw + margin_x))
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))
        sl = np.s_[y0 : y0 + ch, x0 : x0 + cw]
        return img1[sl], img2[sl], disp[sl], valid[sl]

    def __call__(self, img1, img2, disp, valid, rng: np.random.Generator):
        img1, img2 = self.color_transform(img1, img2, rng)
        img2 = eraser_transform(img2, rng, p=self.eraser_aug_prob)
        img1, img2, disp, valid = self.spatial_transform(
            img1, img2, disp, valid, rng
        )
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(disp), np.ascontiguousarray(valid))
