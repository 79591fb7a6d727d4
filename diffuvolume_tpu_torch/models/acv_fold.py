"""ACVNet's folded path: eval BatchNorm folded into the 3-D conv weights,
channels-last volumes, every 3-D conv on the port's fold-conv kernels.

Counterpart of the JAX package's packed path (``diffuvolume_tpu/models/
acv.py``: ``_fold_convbn_params`` / ``_fold_convbn_tree`` /
``_fold_deconv_tree``, ``_hourglass_packed``, ``_aggregate_packed``,
``acv_denoise_fast``, ``_attention_volume_packed``).  Eval only.

``fold_acv(model)`` folds once into a ``FoldedACV``: per conv, the weight
``(k, k, k, C_in, C_out)`` in the model's dtype (folded in float32, then
cast, as the JAX code does) and the bias ``(C_out,)`` in float32; the patch
convs' per-channel stencils ``(3, 3, 48)`` in float32 with their dilations.
Fold once per model and pass the ``FoldedACV`` to
``eval/pipeline.py:acv_ddim_inference`` (fold again after changing the
model's weights); given the ``ACVNet``, the pipeline folds it for that call.
The volumes between convs are ``(B, D, H4, W4, C)``.  The attention chain's
front is channels-last from the start (``acv.py:595-612`` of the JAX
package): the GWC volume is written straight into its 48-channel slot
(``gwc_volume_packed``), the patch convs run on it as two per-channel
stencils in one launch (``depthwise_hw_p2``), and ``dres1_att_0`` reads it.  The
modules the folded path does not touch (feature trunk, concat convs, window
attention, time embedding) run as they are on the module path.

The folding helpers and ``hourglass_folded`` also serve PCWNet's folded
path (``models/pcw_fold.py``), with Mish in the epilogues.

The path needs D, H/4 and W/4 to be multiples of 4 (two stride-2 levels
that the transposed convs undo); on any other shape it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.models.acv import ACVNet, ConcatEntry
from diffuvolume_tpu_torch.models.layers import (
    AttentionBlock3D,
    ConvBN,
    ConvTransposeBN,
    HeadConv3D,
)
from diffuvolume_tpu_torch.ops.cost_volume import slot_width
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume, dhw_mul
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import (
    conv1x1_fold_p,
    conv3d_fold_p,
    conv3d_fold_s2,
    conv3d_fold_x2,
)
from diffuvolume_tpu_torch.ops.kernels.conv3d_up import conv3d_fold_up
from diffuvolume_tpu_torch.ops.kernels.depthwise import depthwise_hw_p2
from diffuvolume_tpu_torch.ops.kernels.fused_head import fused_upsample_softargmin
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume_packed
from diffuvolume_tpu_torch.ops.kernels.layout import pack, unpack
from diffuvolume_tpu_torch.utils.spans import FEATURES, span


class FoldedConv(NamedTuple):
    w: torch.Tensor               # (k, k, k, C_in, C_out), model dtype
    b: torch.Tensor | None        # (C_out,) float32


def _bn_scale_shift(bn) -> tuple[torch.Tensor, torch.Tensor]:
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


def fold_convbn(m: ConvBN, c_slot: int | None = None) -> FoldedConv:
    """``Conv3d → BatchNorm3d`` (eval) as one conv; the weight's input
    channels zero-padded to ``c_slot`` when it is given."""
    conv, bn = m[0], m[1]
    scale, shift = _bn_scale_shift(bn)
    w = (conv.weight.float() * scale[:, None, None, None, None]).permute(2, 3, 4, 1, 0)
    if c_slot is not None and c_slot > w.shape[3]:
        w = F.pad(w, (0, 0, 0, c_slot - w.shape[3]))
    return FoldedConv(w.to(conv.weight.dtype).contiguous(), shift.contiguous())


def fold_deconvbn(m: ConvTransposeBN) -> FoldedConv:
    """``ConvTranspose3d → BatchNorm3d`` (eval) as one transposed conv.  The
    weight is ``(C_in, C_out, k, k, k)``, so the scale goes on dim 1."""
    deconv, bn = m[0], m[1]
    scale, shift = _bn_scale_shift(bn)
    w = (deconv.weight.float() * scale[None, :, None, None, None]).permute(2, 3, 4, 0, 1)
    return FoldedConv(w.to(deconv.weight.dtype).contiguous(), shift.contiguous())


def fold_head(conv: HeadConv3D | torch.nn.Conv3d) -> FoldedConv:
    """A bare ``Conv3d``, no BatchNorm and no bias: the classifier heads'
    ``C → 1`` conv, PCW's strided ``HourglassUp`` convs."""
    return FoldedConv(conv.weight.permute(2, 3, 4, 1, 0).contiguous(), None)


class FoldedStencil(NamedTuple):
    w: torch.Tensor               # (3, 3, C) float32, one (1, 3, 3) stencil a channel
    dil: tuple[int, ...]          # the dilation of each channel


def fold_patch_convs(model: ACVNet, c_slot: int) -> tuple[FoldedStencil, FoldedStencil]:
    """The patch convs (``acv.py:72-79``) as per-channel stencils on the
    ``c_slot``-channel volume: ``patch`` on all G channels at dilation 1,
    then ``patch_l1 / l2 / l3`` on channels 0–7, 8–23 and 24–39 at
    dilations 1, 2 and 3; the fill channels get zero weights (dilation 1)."""

    def stencil(parts):
        w = torch.zeros((3, 3, c_slot), dtype=torch.float32, device=model.patch.weight.device)
        dil = [1] * c_slot
        for conv, lo in parts:
            n = conv.weight.shape[0]
            w[:, :, lo:lo + n] = conv.weight.float()[:, 0, 0].permute(1, 2, 0)
            dil[lo:lo + n] = [conv.dilation[1]] * n
        return FoldedStencil(w.contiguous(), tuple(dil))

    return (stencil([(model.patch, 0)]),
            stencil([(model.patch_l1, 0), (model.patch_l2, 8), (model.patch_l3, 24)]))


class FoldedHourglass(NamedTuple):
    conv1: FoldedConv
    conv2: FoldedConv
    conv3: FoldedConv
    conv4: FoldedConv
    conv5: FoldedConv
    conv6: FoldedConv
    redir1: FoldedConv
    redir2: FoldedConv
    attention: AttentionBlock3D | None


def fold_hourglass(hg) -> FoldedHourglass:
    """``HourglassACV`` (window attention at the bottleneck) or PCW's
    ``HourglassMish`` (none): the same six convs and two redirs."""
    return FoldedHourglass(
        *(fold_convbn(getattr(hg, f"conv{i}")[0]) for i in (1, 2, 3, 4)),
        fold_deconvbn(hg.conv5), fold_deconvbn(hg.conv6),
        fold_convbn(hg.redir1), fold_convbn(hg.redir2), getattr(hg, "attention_block", None),
    )


def hourglass_folded(hg: FoldedHourglass, x: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """The hourglass on a ``(B, D, H, W, C)`` volume (``acv.py:301-356``,
    ``pcw.py:186-205``): conv1 s2 → conv2 → conv3 s2 → conv4 → [unpack →
    attention → pack] → conv5 = act(deconv + redir2) → conv6 = act(deconv +
    redir1)."""
    c1 = conv3d_fold_s2(x, *hg.conv1, act=act)
    c2 = conv3d_fold_p(c1, *hg.conv2, act=act)
    c3 = conv3d_fold_s2(c2, *hg.conv3, act=act)
    c4 = conv3d_fold_p(c3, *hg.conv4, act=act)
    if hg.attention is not None:
        c4 = pack(hg.attention(unpack(c4)))
    c5 = conv3d_fold_up(c4, *hg.conv5, residual=conv1x1_fold_p(c2, *hg.redir2), act=act)
    return conv3d_fold_up(c5, *hg.conv6, residual=conv1x1_fold_p(x, *hg.redir1), act=act)


def _check_geometry(d: int, h4: int, w4: int) -> None:
    if d % 4 or h4 % 4 or w4 % 4:
        raise ValueError(
            f"the folded path needs D, H/4 and W/4 to be multiples of 4, got {d}, {h4}, {w4}")


class FoldedACV:
    """An eval ``ACVNet`` with its 3-D conv chains folded (see the module
    docstring).  Holds the model for the modules it runs unfolded."""

    def __init__(self, model: ACVNet):
        if model.training:
            raise ValueError("BatchNorm folding needs an eval-mode model")
        self.model = model
        self.att_slot = slot_width(model.num_groups)  # 40 → 48, the kernels' K step
        self.patch, self.patch_l123 = fold_patch_convs(model, self.att_slot)
        self.dres1_att_0 = fold_convbn(model.dres1_att_[0], self.att_slot)
        self.dres1_att_1 = fold_convbn(model.dres1_att_[2])
        self.dres2_att_ = fold_hourglass(model.dres2_att_)
        self.classif_att_0 = fold_convbn(model.classif_att_[0])
        self.classif_att_1 = fold_head(model.classif_att_[2])
        self.dres0_0 = fold_convbn(model.dres0[0])
        self.dres0_1 = fold_convbn(model.dres0[2])
        self.dres1_0 = fold_convbn(model.dres1[0])
        self.dres1_1 = fold_convbn(model.dres1[2])
        self.dres2 = fold_hourglass(model.dres2)
        self.dres3 = fold_hourglass(model.dres3)
        self.classif2_0 = fold_convbn(model.classif2[0])
        self.classif2_1 = fold_head(model.classif2[2])

    def build_cost_volume(self, left: torch.Tensor, right: torch.Tensor):
        """``ACVNet.build_cost_volume`` with the attention chain folded and
        channels-last from the GWC volume on (``acv.py:546-654`` of the JAX
        package, its packed branch, ``595-612``): the trunk, the 40-group
        volume written into its 48-channel slot, the two patch stencils (one
        launch), then ``dres1_att_0`` on the slot."""
        m = self.model
        _check_geometry(m.max_disp // 4, left.shape[1] // 4, left.shape[2] // 4)
        with span(FEATURES):
            feat_l, feat_r = m.trunk(left, right)
        vol = gwc_volume_packed(feat_l, feat_r, m.max_disp // 4, m.num_groups, self.att_slot)
        vol = depthwise_hw_p2(vol, *self.patch, *self.patch_l123)
        a = conv3d_fold_x2(vol, *self.dres1_att_0, act="relu")
        a = conv3d_fold_p(a, *self.dres1_att_1)
        a = hourglass_folded(self.dres2_att_, a)
        a = conv3d_fold_p(a, *self.classif_att_0, act="relu")
        att_weights = conv3d_fold_p(a, *self.classif_att_1)[..., 0]  # (B, D, H4, W4)
        return m.concat_and_attention(feat_l, feat_r, att_weights)

    def aggregate(self, volume: torch.Tensor, out_hw: tuple[int, int]):
        """``(B, D, H4, W4, 2C)`` volume → ``(disp, unc)`` at ``out_hw``
        (``acv.py:385-488``): dres0 → dres1 + residual → two hourglasses →
        classif2 → the fused head."""
        _check_geometry(*volume.shape[1:4])
        x = conv3d_fold_x2(volume, *self.dres0_0, act="relu")
        y = conv3d_fold_p(x, *self.dres0_1, act="relu")
        z = conv3d_fold_p(y, *self.dres1_0, act="relu")
        c0 = conv3d_fold_p(z, *self.dres1_1, residual=y)
        out2 = hourglass_folded(self.dres3, hourglass_folded(self.dres2, c0))
        h = conv3d_fold_p(out2, *self.classif2_0, act="relu")
        cost = conv3d_fold_p(h, *self.classif2_1)[..., 0]  # (B, D, H4, W4)
        return fused_upsample_softargmin(cost.float().contiguous(), self.model.max_disp, out_hw)

    def denoise(self, entry: ConcatEntry, latent: torch.Tensor, t: torch.Tensor,
                out_hw: tuple[int, int]):
        """``ACVNet.denoise`` on the folded path (``acv_denoise_fast``,
        ``acv.py:491-509``); ``entry.volume`` is channels-last."""
        noise = self.model.embed_noise(latent, t)
        vol = dhw_mul(entry.volume, entry.att, noise.to(entry.att.dtype).contiguous(),
                      channels_last=True)
        disp, unc = self.aggregate(vol, out_hw)
        return disp, unc, noise.float()

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """The baseline eval forward: ``[disp (B, H, W)]``."""
        cl, cr, att = self.build_cost_volume(left, right)
        vol = concat_volume(cl, cr, self.model.max_disp // 4, att=att, channels_last=True)
        disp, _ = self.aggregate(vol, (left.shape[1], left.shape[2]))
        return [disp]

    __call__ = forward


def fold_acv(model: ACVNet) -> FoldedACV:
    """Fold ``model`` (eval) into a ``FoldedACV``."""
    with torch.no_grad():
        return FoldedACV(model)

