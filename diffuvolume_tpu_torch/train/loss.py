"""Training losses.

Counterpart of ``diffuvolume_tpu/train/loss.py``: the reference's smooth-L1
over masked pixels with per-head weights (SceneFlow/models/loss.py,
KITTI12/models/loss.py) and the KITTI15 sequence loss
(KITTI15/train_stereo.py:33-62), as masked weighted means.  Under data
parallelism (``parallel/ddp.py``) ``reduce`` sums the count of valid
pixels over the ranks: each rank's loss is then its share of the global
batch's, as under the JAX package's mesh, where the mean is global.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Reduce = Callable[[torch.Tensor], torch.Tensor] | None

SCENEFLOW_WEIGHTS = (0.5, 0.5, 0.7, 1.0)  # [pred_att, pred0, pred1, pred2]
SCENEFLOW_WEIGHTS_FREEZE_ATTN = (0.5, 0.7, 1.0)
SCENEFLOW_WEIGHTS_ATTN_ONLY = (1.0,)
KITTI12_WEIGHTS = (0.5, 0.5, 0.5, 0.7, 1.0, 1.3)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber with beta 1), ``F.smooth_l1_loss``'s
    terms."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_count(mask: torch.Tensor, dtype: torch.dtype, reduce: Reduce = None) -> torch.Tensor:
    """``max(Σ mask, 1)``, the sum over the ranks with ``reduce``."""
    n = mask.to(dtype).sum()
    return (n if reduce is None else reduce(n)).clamp_min(1.0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor | None = None) -> torch.Tensor:
    """``Σ x·mask / count``, ``count`` by default ``max(Σ mask, 1)``."""
    m = mask.to(x.dtype)
    return (x * m).sum() / (masked_count(mask, x.dtype) if count is None else count)


def multi_scale_loss(disp_ests: Sequence[torch.Tensor], disp_gt: torch.Tensor,
                     mask: torch.Tensor, weights: Sequence[float] = SCENEFLOW_WEIGHTS,
                     reduce: Reduce = None) -> torch.Tensor:
    """Weighted smooth-L1 over the prediction heads (loss.py:19-24)."""
    if len(disp_ests) != len(weights):
        raise ValueError(f"{len(disp_ests)} heads for {len(weights)} weights")
    count = masked_count(mask, disp_ests[0].dtype, reduce)
    return sum(w * masked_mean(smooth_l1(est, disp_gt), mask, count)
               for est, w in zip(disp_ests, weights))


def sequence_loss(disp_preds: Sequence[torch.Tensor] | torch.Tensor, init_disp: torch.Tensor,
                  disp_gt: torch.Tensor, valid: torch.Tensor, loss_gamma: float = 0.9,
                  max_disp: float = 192.0, reduce: Reduce = None) -> torch.Tensor:
    """IGEV's γ-discounted iterate loss (KITTI15/train_stereo.py:33-62).

    ``disp_preds``: the GRU iterates ``(N, B, H, W)`` (or a list);
    ``init_disp``: ``(B, H, W)``; ``valid``: ``(B, H, W)``, combined with
    ``|gt| < max_disp``.  γ is adjusted to ``γ^(15/(N−1))``.
    """
    n = len(disp_preds)
    mask = (valid >= 0.5) & (disp_gt.abs() < max_disp)
    count = masked_count(mask, init_disp.dtype, reduce)
    gamma = loss_gamma ** (15.0 / max(n - 1, 1))
    total = masked_mean(smooth_l1(init_disp, disp_gt), mask, count)
    for i in range(n):
        total = total + gamma ** (n - i - 1) * masked_mean((disp_preds[i] - disp_gt).abs(),
                                                           mask, count)
    return total
