"""Input padding to stride multiples (KITTI15/core/utils/utils.py:7-26).

Counterpart of ``diffuvolume_tpu/utils/padding.py`` on torch tensors, in the
same channels-last layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pad (H, W) up to a multiple of ``divis_by`` by replicating the edge,
    then unpad.

    ``sintel`` mode splits the padding between both sides of each axis
    (the extra pixel at the bottom / right); any other mode pads the width
    on both sides and the height at the bottom only.  KITTI15's evaluation
    uses ``divis_by=32`` (evaluate_stereo.py:85).  Channels-last
    ``(B, H, W, C)`` tensors.
    """

    def __init__(self, shape, divis_by: int = 32, mode: str = "sintel"):
        self.ht, self.wd = shape[-3], shape[-2]
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        """Each ``(B, H, W, C)`` input padded to ``(B, H', W', C)``."""
        return [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate").permute(0, 2, 3, 1)
                for x in inputs]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """The padding cut from a ``(B, H', W', C)`` or ``(B, H', W')``
        tensor."""
        l, r, t, b = self._pad
        if x.dim() >= 4:
            return x[..., t:x.shape[-3] - b if b else None, l:x.shape[-2] - r if r else None, :]
        return x[:, t:x.shape[1] - b if b else None, l:x.shape[2] - r if r else None]
