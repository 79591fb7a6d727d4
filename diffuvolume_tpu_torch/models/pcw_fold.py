"""PCWNet's folded path: eval BatchNorm folded into the 3-D conv weights,
channels-last volumes, every 3-D conv on the port's fold-conv kernels with a
Mish epilogue.

Counterpart of the JAX package's packed PCW path (``diffuvolume_tpu/models/
pcw.py``: ``_pcw_build_packed``, ``_hourglass_up_packed``,
``_hourglass_mish_packed``, ``_pcw_aggregate_packed``, ``pcw_prep_fast``,
``pcw_denoise_fast``).  Eval only.  The folding helpers and the hourglass
are ``models/acv_fold.py``'s.

``fold_pcw(model)`` folds once into a ``FoldedPCW``; pass it to
``eval/pipeline.py:pcw_ddim_inference`` (fold again after changing the
model's weights).  All four volumes (1/4 … 1/32) come channels-last from
``gwc_volume_packed`` in 64-channel slots (40 groups + 12 + 12 concat).
``HourglassUp``'s ``conv(concat(a, v))`` runs as two convs, the volume's
part first as the residual of the other's: exact by linearity, and no
concatenated copy (the JAX packed path does the same, ``pcw.py:549-569``).
Unlike the JAX path, the 1/32 level (conv5 s2, combine3, conv6, the conv7
transposed conv and redir3) runs on the kernels too.  The 2-D trunk, the
refinement net and the time embedding run as they are on the module path.

The path needs D, H/4 and W/4 to be multiples of 8 (three stride-2 levels
that the transposed convs undo); on any other shape it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diffuvolume_tpu_torch.models.acv_fold import (
    FoldedConv,
    fold_convbn,
    fold_deconvbn,
    fold_head,
    fold_hourglass,
    hourglass_folded,
)
from diffuvolume_tpu_torch.models.pcw import HourglassUp, PCWEntry, PCWNet
from diffuvolume_tpu_torch.ops.kernels.concat_volume import dhw_mul
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import (
    conv1x1_fold_p,
    conv3d_fold_p,
    conv3d_fold_s2,
    conv3d_fold_x2,
)
from diffuvolume_tpu_torch.ops.kernels.conv3d_up import conv3d_fold_up
from diffuvolume_tpu_torch.ops.kernels.fused_head import (
    fused_uncertainty_at,
    fused_upsample_softargmin,
)


def _split(fc: FoldedConv, c: int) -> tuple[FoldedConv, FoldedConv]:
    """A conv over ``concat(a, v)`` as its ``a`` part (with the bias) and
    its ``v`` part (without): the weight's first ``c`` input channels and
    the rest."""
    return (FoldedConv(fc.w[:, :, :, :c].contiguous(), fc.b),
            FoldedConv(fc.w[:, :, :, c:].contiguous(), None))


class FoldedHourglassUp(NamedTuple):
    conv1: FoldedConv
    combine1: FoldedConv      # on conv1's output, with the bias
    combine1_v: FoldedConv    # on the 1/8 volume
    conv2: FoldedConv
    conv3: FoldedConv
    combine2: FoldedConv
    combine2_v: FoldedConv    # on the 1/16 volume
    conv4: FoldedConv
    conv5: FoldedConv
    combine3: FoldedConv
    combine3_v: FoldedConv    # on the 1/32 volume
    conv6: FoldedConv
    conv7: FoldedConv
    conv8: FoldedConv
    conv9: FoldedConv
    redir1: FoldedConv
    redir2: FoldedConv
    redir3: FoldedConv


def fold_hourglass_up(hg: HourglassUp) -> FoldedHourglassUp:
    ch = hg.conv1.weight.shape[1]
    c1, c1v = _split(fold_convbn(hg.combine1[0]), 2 * ch)
    c2, c2v = _split(fold_convbn(hg.combine2[0]), 4 * ch)
    c3, c3v = _split(fold_convbn(hg.combine3[0]), 4 * ch)
    return FoldedHourglassUp(
        fold_head(hg.conv1), c1, c1v, fold_convbn(hg.conv2[0]),
        fold_head(hg.conv3), c2, c2v, fold_convbn(hg.conv4[0]),
        fold_head(hg.conv5), c3, c3v, fold_convbn(hg.conv6[0]),
        fold_deconvbn(hg.conv7), fold_deconvbn(hg.conv8), fold_deconvbn(hg.conv9),
        fold_convbn(hg.redir1), fold_convbn(hg.redir2), fold_convbn(hg.redir3))


def hourglass_up_folded(hg: FoldedHourglassUp, x: torch.Tensor, v2: torch.Tensor,
                        v3: torch.Tensor, v4: torch.Tensor, act: str) -> torch.Tensor:
    """``HourglassUp`` on channels-last volumes (``pcw.py:142-183``): at each
    level a stride-2 conv, then the combine conv over it and that scale's
    volume (two convs), then a conv; back up by transposed convs, each plus
    its redir and the activation."""
    c1 = conv3d_fold_s2(x, *hg.conv1)
    c1 = conv3d_fold_p(c1, *hg.combine1, residual=conv3d_fold_p(v2, *hg.combine1_v), act=act)
    c2 = conv3d_fold_p(c1, *hg.conv2, act=act)
    c3 = conv3d_fold_s2(c2, *hg.conv3)
    c3 = conv3d_fold_p(c3, *hg.combine2, residual=conv3d_fold_p(v3, *hg.combine2_v), act=act)
    c4 = conv3d_fold_p(c3, *hg.conv4, act=act)
    c5 = conv3d_fold_s2(c4, *hg.conv5)
    c5 = conv3d_fold_p(c5, *hg.combine3, residual=conv3d_fold_p(v4, *hg.combine3_v), act=act)
    c6 = conv3d_fold_p(c5, *hg.conv6, act=act)
    c7 = conv3d_fold_up(c6, *hg.conv7, residual=conv1x1_fold_p(c4, *hg.redir3), act=act)
    c8 = conv3d_fold_up(c7, *hg.conv8, residual=conv1x1_fold_p(c2, *hg.redir2), act=act)
    return conv3d_fold_up(c8, *hg.conv9, residual=conv1x1_fold_p(x, *hg.redir1), act=act)


def _check_geometry(d: int, h4: int, w4: int) -> None:
    if d % 8 or h4 % 8 or w4 % 8:
        raise ValueError(
            f"the folded PCW path needs D, H/4 and W/4 to be multiples of 8, got {d}, {h4}, {w4}")


class FoldedPCW:
    """An eval ``PCWNet`` with its 3-D conv chains folded (see the module
    docstring).  Holds the model for the modules it runs unfolded."""

    def __init__(self, model: PCWNet):
        if model.training:
            raise ValueError("BatchNorm folding needs an eval-mode model")
        self.model = model
        self.act = model.act
        self.dres0_0 = fold_convbn(model.dres0[0])
        self.dres0_1 = fold_convbn(model.dres0[2])
        self.dres1_0 = fold_convbn(model.dres1[0])
        self.dres1_1 = fold_convbn(model.dres1[2])
        self.combine1 = fold_hourglass_up(model.combine1)
        self.dres2 = fold_hourglass(model.dres2)
        self.dres3 = fold_hourglass(model.dres3)
        self.dres4 = fold_hourglass(model.dres4)
        self.classif3_0 = fold_convbn(model.classif3[0])
        self.classif3_1 = fold_head(model.classif3[2])

    def build_cost_volume(self, left: torch.Tensor, right: torch.Tensor):
        """``PCWNet.build_cost_volume`` folded (``_pcw_build_packed``):
        ``(combine (B, D, H4, W4, 32), cost0 (B, D, H4, W4, 32), fl, fr)``."""
        m, act = self.model, self.act
        _check_geometry(m.max_disp // 4, left.shape[1] // 4, left.shape[2] // 4)
        fl, fr = m.features(left, right)
        v1, v2, v3, v4 = m.volumes(fl, fr)
        y = conv3d_fold_p(conv3d_fold_x2(v1, *self.dres0_0, act=act), *self.dres0_1, act=act)
        z = conv3d_fold_p(y, *self.dres1_0, act=act)
        cost0 = conv3d_fold_p(z, *self.dres1_1, residual=y)
        return hourglass_up_folded(self.combine1, cost0, v2, v3, v4, act), cost0, fl, fr

    def aggregate(self, volume: torch.Tensor, fl: dict, fr: dict, out_hw: tuple[int, int],
                  want_unc: bool = True):
        """``(B, D, H4, W4, 32)`` volume → ``(disp_finetune, unc)`` at
        ``out_hw`` (``_pcw_aggregate_packed``): three Mish hourglasses, the
        classif3 head, the fused head, the refinement net, and the
        uncertainty against the refined disparity (None unless
        ``want_unc``)."""
        m, act = self.model, self.act
        _check_geometry(*volume.shape[1:4])
        x = volume
        for hg in (self.dres2, self.dres3, self.dres4):
            x = hourglass_folded(hg, x, act)
        h = conv3d_fold_p(x, *self.classif3_0, act=act)
        cost3 = conv3d_fold_p(h, *self.classif3_1)[..., 0].float().contiguous()
        pred3, _ = fused_upsample_softargmin(cost3, m.max_disp, out_hw, align_corners=True)
        disp = m.refine(pred3, fl, fr, out_hw)
        unc = (fused_uncertainty_at(cost3, disp, m.max_disp, out_hw, align_corners=True)
               if want_unc else None)
        return disp, unc

    def denoise(self, entry: PCWEntry, latent: torch.Tensor, t: torch.Tensor,
                out_hw: tuple[int, int]):
        """``PCWNet.denoise`` on the folded path (``pcw_denoise_fast``);
        ``entry.volume`` is channels-last."""
        noise = self.model.embed_noise(latent, t)
        vol = dhw_mul(entry.volume, noise.to(entry.volume.dtype).contiguous(), None,
                      channels_last=True)
        disp, unc = self.aggregate(vol, entry.fl, entry.fr, out_hw)
        return disp, unc, noise.float()

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """The baseline eval forward: ``[disp_finetune (B, H, W)]``."""
        combine, _, fl, fr = self.build_cost_volume(left, right)
        disp, _ = self.aggregate(combine, fl, fr, (left.shape[1], left.shape[2]),
                                 want_unc=False)
        return [disp]

    __call__ = forward


def fold_pcw(model: PCWNet) -> FoldedPCW:
    """Fold ``model`` (eval) into a ``FoldedPCW``."""
    with torch.no_grad():
        return FoldedPCW(model)
