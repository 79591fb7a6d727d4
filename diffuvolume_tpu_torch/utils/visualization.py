"""Disparity error-map visualization (SceneFlow/utils/visualization.py:11-58).

The port's own copy of ``diffuvolume_tpu/utils/visualization.py``: the
10-band KITTI error colormap, error thresholds in units of (abs error,
relative error) mapped to a fixed color table.
"""

from __future__ import annotations

import numpy as np

_ERROR_COLORMAP = np.array(
    [
        [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
        [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
        [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
        [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
        [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
        [3 / 3.0, 6 / 3.0, 254, 224, 144],
        [6 / 3.0, 12 / 3.0, 253, 174, 97],
        [12 / 3.0, 24 / 3.0, 244, 109, 67],
        [24 / 3.0, 48 / 3.0, 215, 48, 39],
        [48 / 3.0, float("inf"), 165, 0, 38],
    ],
    dtype=np.float64,
)


def disp_error_image(d_est: np.ndarray, d_gt: np.ndarray, abs_thres: float = 3.0,
                     rel_thres: float = 0.05) -> np.ndarray:
    """(H, W) est/gt → (H, W, 3) uint8 error image; invalid gt (<=0) black."""
    d_est = np.asarray(d_est, np.float64)
    d_gt = np.asarray(d_gt, np.float64)
    valid = d_gt > 0
    error = np.abs(d_est - d_gt)
    norm = np.minimum(error / abs_thres, error / np.maximum(np.abs(d_gt), 1e-12) / rel_thres)
    out = np.zeros((*d_gt.shape, 3), np.uint8)
    for lo, hi, r, g, b in _ERROR_COLORMAP:
        m = valid & (norm >= lo) & (norm < hi)
        out[m] = (int(r), int(g), int(b))
    return out
