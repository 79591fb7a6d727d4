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
``gwc_volume_packed``, each in the slot ``slot_width`` gives its channels:
40 groups + 12 + 12 concat in 64, or without the concat volume
(``gwcnet-g``) the 40 groups in 48, the weights that read them zero-padded
to the slot (the slot's fill is zero, so the padding is exact).
``HourglassUp``'s ``conv(concat(a, v))`` runs as two convs, the volume's
part first as the residual of the other's: exact by linearity, and no
concatenated copy (the JAX packed path does the same, ``pcw.py:549-569``).
Unlike the JAX path, the 1/32 level (conv5 s2, combine3, conv6, the conv7
transposed conv and redir3) runs on the kernels too.  The 2-D trunk, the
refinement's input (resize, warp, signed correlation, ``dispupsample``) and
the time embedding run as they are on the module path.

``fold_pcw`` also folds the refinement net (``RefineNetV3``) of a bfloat16
model, the counterpart of the JAX package's ``_refine_flat``
(``DIFFU_PCW_REFINE_FLAT=1``): each 3×3 conv's BatchNorm folded into its
weight and bias in float32, every 3×3 conv (``conv8``, 32 → 1 without
BatchNorm, too) on ``conv2d_flat`` (TPU row 18) channels-last with the Mish
and the residual blocks' adds in its epilogue, the three 1×1 ``downsample``
projections on ``conv1x1_fold_p`` (row 9) with their BatchNorm folded.  The
146-channel input is packed channels-last into a zero-filled 160-channel
slot (``layout.pack``, row 11), ``conv1``'s weight zero-padded to match.  A float32 model keeps the module refinement on
cuDNN, the JAX package's default: ``conv2d_flat``'s float32 form is a plain
FMA kernel.  ``refine_flat=True`` / ``False`` forces one or the other.

The path needs D, H/4 and W/4 to be multiples of 8 (three stride-2 levels
that the transposed convs undo); on any other shape it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.models.acv_fold import (
    FoldedConv,
    _bn_scale_shift,
    fold_convbn,
    fold_deconvbn,
    fold_head,
    fold_hourglass,
    hourglass_folded,
)
from diffuvolume_tpu_torch.models.layers import ConvBN
from diffuvolume_tpu_torch.models.pcw import HourglassUp, PCWEntry, PCWNet, RefineNetV3
from diffuvolume_tpu_torch.ops.cost_volume import slot_width
from diffuvolume_tpu_torch.ops.kernels.concat_volume import dhw_mul
from diffuvolume_tpu_torch.ops.kernels.conv2d import conv2d_flat
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
from diffuvolume_tpu_torch.ops.kernels.layout import pack
from diffuvolume_tpu_torch.utils.spans import FEATURES, REFINE, span


def _split(fc: FoldedConv, c: int, v_slot: int) -> tuple[FoldedConv, FoldedConv]:
    """A conv over ``concat(a, v)`` as its ``a`` part (with the bias) and
    its ``v`` part (without): the weight's first ``c`` input channels and
    the rest, zero-padded to the volume's ``v_slot`` channels."""
    v = fc.w[:, :, :, c:]
    return (FoldedConv(fc.w[:, :, :, :c].contiguous(), fc.b),
            FoldedConv(F.pad(v, (0, 0, 0, v_slot - v.shape[3])).contiguous(), None))


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


def fold_hourglass_up(hg: HourglassUp, v_slot: int) -> FoldedHourglassUp:
    """``hg`` folded for volumes in ``v_slot``-channel slots."""
    ch = hg.conv1.weight.shape[1]
    c1, c1v = _split(fold_convbn(hg.combine1[0]), 2 * ch, v_slot)
    c2, c2v = _split(fold_convbn(hg.combine2[0]), 4 * ch, v_slot)
    c3, c3v = _split(fold_convbn(hg.combine3[0]), 4 * ch, v_slot)
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


# The refinement input's 146 channels in a slot whose rows are whole 16-byte
# vectors for the kernel's copies.
REFINE_SLOT = 160


class FoldedConv2d(NamedTuple):
    w: torch.Tensor               # (3, 3, C_in, C_out), model dtype
    b: torch.Tensor | None        # (C_out,) float32
    dil: int


def fold_convbn2d(m: ConvBN, c_slot: int | None = None) -> FoldedConv2d:
    """``Conv2d → BatchNorm2d`` (eval) as one 3×3 conv (``fold_convbn``'s 2-D
    form); the weight's input channels zero-padded to ``c_slot`` when it is
    given."""
    conv, bn = m[0], m[1]
    scale, shift = _bn_scale_shift(bn)
    w = (conv.weight.float() * scale[:, None, None, None]).permute(2, 3, 1, 0)
    if c_slot is not None and c_slot > w.shape[2]:
        w = F.pad(w, (0, 0, 0, c_slot - w.shape[2]))
    return FoldedConv2d(w.to(conv.weight.dtype).contiguous(), shift.contiguous(),
                        conv.dilation[0])


class FoldedBlock(NamedTuple):
    conv1: FoldedConv2d
    conv2: FoldedConv2d
    down_w: torch.Tensor          # (1, 1, 1, C_in, C_out), model dtype
    down_b: torch.Tensor          # (C_out,) float32


class FoldedRefine(NamedTuple):
    convs: tuple                  # conv1 … conv4, each followed by the activation
    blocks: tuple                 # conv5 … conv7
    conv8: FoldedConv2d           # 32 → 1, no BatchNorm, no bias


def fold_refine(net: RefineNetV3) -> FoldedRefine:
    """``RefineNetV3`` (eval) folded for ``refine_flat``."""
    blocks = []
    for i in (5, 6, 7):
        blk = getattr(net, f"conv{i}")[0]
        scale, shift = _bn_scale_shift(blk.downsample[1])
        down = blk.downsample[0].weight
        blocks.append(FoldedBlock(
            fold_convbn2d(blk.conv1[0]), fold_convbn2d(blk.conv2),
            (down.float() * scale[:, None, None, None]).permute(2, 3, 1, 0)[None]
            .to(down.dtype).contiguous(),
            shift.contiguous()))
    return FoldedRefine(
        (fold_convbn2d(net.conv1[0], REFINE_SLOT),
         *(fold_convbn2d(getattr(net, f"conv{i}")[0]) for i in (2, 3, 4))),
        tuple(blocks),
        FoldedConv2d(net.conv8.weight.permute(2, 3, 1, 0).contiguous(), None, 1))


def refine_flat(fr: FoldedRefine, x: torch.Tensor, disp: torch.Tensor, act: str) -> torch.Tensor:
    """The folded refinement net on the ``(B, 146, H, W)`` input ``x``
    (``_refine_flat``, ``pcw.py:684-743`` of the JAX package): conv1 … conv4
    with the activation, three residual blocks (act(conv1) → conv2 + the
    1×1 downsample), conv8; each conv's activation and residual in its
    epilogue, the input packed channels-last into its zero-filled slot by
    row 11's transposer.  Returns ``disp + residual`` ``(B, H, W)``
    float32."""
    y = pack(x[:, :, None], REFINE_SLOT)[:, 0]
    for fc in fr.convs:
        y = conv2d_flat(y, *fc, act=act)
    for blk in fr.blocks:
        o = conv2d_flat(y, *blk.conv1, act=act)
        ds = conv1x1_fold_p(y[:, None], blk.down_w, blk.down_b)[:, 0]
        y = conv2d_flat(o, *blk.conv2, residual=ds)
    return disp.float() + conv2d_flat(y, *fr.conv8)[..., 0].float()


def _check_geometry(d: int, h4: int, w4: int) -> None:
    if d % 8 or h4 % 8 or w4 % 8:
        raise ValueError(
            f"the folded PCW path needs D, H/4 and W/4 to be multiples of 8, got {d}, {h4}, {w4}")


class FoldedPCW:
    """An eval ``PCWNet`` with its 3-D conv chains folded (see the module
    docstring).  Holds the model for the modules it runs unfolded."""

    def __init__(self, model: PCWNet, refine_flat: bool | None = None):
        if model.training:
            raise ValueError("BatchNorm folding needs an eval-mode model")
        self.model = model
        self.act = model.act
        if refine_flat is None:
            refine_flat = model.dtype == torch.bfloat16
        self.refine = fold_refine(model.refinenet3) if refine_flat else None
        # The volumes' slot: 64 (40 + 12 + 12), or 48 without the concat volume.
        slot = slot_width(model.num_groups + 2 * model.concat_channels)
        self.dres0_0 = fold_convbn(model.dres0[0], slot)
        self.dres0_1 = fold_convbn(model.dres0[2])
        self.dres1_0 = fold_convbn(model.dres1[0])
        self.dres1_1 = fold_convbn(model.dres1[2])
        self.combine1 = fold_hourglass_up(model.combine1, slot)
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
        with span(FEATURES):
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
        classif3 head, the fused head, the refinement net (folded on
        ``conv2d_flat`` where ``fold_pcw`` folded it), and the
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
        with span(REFINE):
            if self.refine is None:
                disp = m.refine(pred3, fl, fr, out_hw)
            else:
                disp = refine_flat(self.refine, m.refine_input(pred3, fl, fr, out_hw), pred3,
                                   act)
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


def fold_pcw(model: PCWNet, refine_flat: bool | None = None) -> FoldedPCW:
    """Fold ``model`` (eval) into a ``FoldedPCW``, with its refinement net
    (every 3×3 conv on ``conv2d_flat``) where ``refine_flat`` is True, or is
    None and the model is bfloat16."""
    with torch.no_grad():
        return FoldedPCW(model, refine_flat)
