"""IGEV's folded GEV tower: eval BatchNorm folded into the 3-D conv weights,
channels-last volumes, every 3-D conv of the tower on the port's kernels
with a LeakyReLU epilogue and the feature attentions as the epilogue's
``post_mul``.

Counterpart of the JAX package's ``gev_tower_packed``
(``diffuvolume_tpu/models/igev/gev_packed.py:84-247``).  Eval only.
``fold_igev(model)`` folds once into a ``FoldedIGEV``; pass it to
``eval/pipeline.py:igev_ddim_inference`` (fold again after changing the
model's weights).  Per launch:

* the 8-group volume written into a 16-channel slot (``gwc_volume_packed``);
* ``corr_stem`` (``conv3d_fold_p``, leaky, × its attention);
* per level 1/8, 1/16, 1/32: the stride-2 conv (``conv3d_fold_s2``, leaky),
  then the conv with leaky and × the level's attention (``conv3d_fold_p``);
* ``conv3_up`` / ``conv2_up``: k4 transposed convs with leaky
  (``conv3d_fold_up``);
* ``agg0_0`` / ``agg1_0``, 1×1 convs over ``concat(up, skip)``: two 1×1
  launches (``conv1x1_fold_p``), the skip's part first, then the other's with
  it as the residual and leaky (exact by linearity; no concatenated copy);
  then the two 3×3×3 convs, the second × the attention;
* ``conv1_up``: the k4 transposed conv, no BatchNorm, bias or activation;
* the 8 → 1 classifier (``conv3d_fold_p``);
* the GEV and the classifier's cost to the lookup's layouts
  (``unpack_hwdc``: ``(B, H, W, D, 8)`` and ``(B, H, W, D)``).

The 8-channel volumes (the correlation, ``corr_stem``'s output, the GEV)
live in 16-wide slots whose extra channels have zero weights, bias and
attention, so they stay zero: exact, as the JAX package's 48 → 64 padding
at 1/32 is (the port needs none there: 48 is a multiple of 16).  The
attention maps (two 1×1 2-D convs and a sigmoid) are PyTorch ops in float32.
The trunk, the context encoder and the GRU run as on the module path.

The path needs D, H/4 and W/4 to be multiples of 8 (three stride-2 levels
that the transposed convs undo); on any other shape it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.models.acv_fold import FoldedConv, _bn_scale_shift
from diffuvolume_tpu_torch.models.igev.extractor import BasicConv, leaky_relu
from diffuvolume_tpu_torch.models.igev.model import (
    GEV_GROUPS,
    FeatureAtt,
    IGEVEncoding,
    IGEVStereo,
)
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import (
    conv1x1_fold_p,
    conv3d_fold_p,
    conv3d_fold_s2,
)
from diffuvolume_tpu_torch.ops.kernels.conv3d_up import conv3d_fold_up
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume_packed
from diffuvolume_tpu_torch.ops.kernels.layout import unpack_hwdc

SLOT = 16
LEAKY = "leaky"
# The hourglass's feature attentions and the pyramid level of their features.
ATT_LEVELS = {"8": 1, "16": 2, "32": 3, "up_16": 2, "up_8": 1}


def _pad(w: torch.Tensor, b: torch.Tensor | None, cin: int | None = None,
         cout: int | None = None) -> FoldedConv:
    """A folded ``(k, k, k, C_in, C_out)`` weight (and bias) zero-padded to
    ``cin`` / ``cout`` channels."""
    if cin is not None and cin > w.shape[3]:
        w = F.pad(w, (0, 0, 0, cin - w.shape[3]))
    if cout is not None and cout > w.shape[4]:
        if b is not None:
            b = F.pad(b, (0, cout - w.shape[4]))
        w = F.pad(w, (0, cout - w.shape[4]))
    return FoldedConv(w.contiguous(), None if b is None else b.contiguous())


def fold_basic(m: BasicConv, cin: int | None = None, cout: int | None = None) -> FoldedConv:
    """A 3-D ``BasicConv`` (conv or transposed conv, BatchNorm or none) as
    one conv: ``(k, k, k, C_in, C_out)`` in the model's dtype (folded in
    float32), bias ``(C_out,)`` float32 or None; channels padded to ``cin`` /
    ``cout``."""
    conv = m.conv
    transposed = isinstance(conv, torch.nn.ConvTranspose3d)
    w = conv.weight.float()
    b = None
    if m.bn is not None:
        scale, b = _bn_scale_shift(m.bn)
        w = w * (scale[None, :, None, None, None] if transposed
                 else scale[:, None, None, None, None])
    w = w.permute(2, 3, 4, 0, 1) if transposed else w.permute(2, 3, 4, 1, 0)
    return _pad(w.to(conv.weight.dtype), b, cin, cout)


def _split(fc: FoldedConv, c: int) -> tuple[FoldedConv, FoldedConv]:
    """A 1×1 conv over ``concat(a, v)`` as its ``a`` part (with the bias) and
    its ``v`` part (without)."""
    return (FoldedConv(fc.w[:, :, :, :c].contiguous(), fc.b),
            FoldedConv(fc.w[:, :, :, c:].contiguous(), None))


class FoldedAtt(NamedTuple):
    """A ``FeatureAtt`` in float32: the 1×1 conv with its BatchNorm folded,
    then the 1×1 conv with bias; ``slot`` the width the map is padded to."""
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    slot: int


def fold_att(fa: FeatureAtt, slot: int | None = None) -> FoldedAtt:
    bc, conv1 = fa.feat_att[0], fa.feat_att[1]
    scale, shift = _bn_scale_shift(bc.bn)
    w0 = bc.conv.weight.float() * scale[:, None, None, None]
    return FoldedAtt(w0, shift, conv1.weight.float(), conv1.bias.float(),
                     slot or conv1.weight.shape[0])


def att_map(a: FoldedAtt, feat: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``sigmoid(att1(leaky(bn(att0(feat)))))`` in float32 (``_att_map``):
    ``feat (B, C, H, W)`` → ``(B, H, W, slot)`` in ``dtype``, channels past
    the attention's zero."""
    x = leaky_relu(F.conv2d(feat.float(), a.w0, a.b0))
    x = torch.sigmoid(F.conv2d(x, a.w1, a.b1)).permute(0, 2, 3, 1)
    return F.pad(x, (0, a.slot - x.shape[-1])).to(dtype).contiguous()


def _check_geometry(d: int, h4: int, w4: int) -> None:
    if d % 8 or h4 % 8 or w4 % 8:
        raise ValueError(
            f"the folded IGEV path needs D, H/4 and W/4 to be multiples of 8, got {d}, {h4}, {w4}")


class FoldedIGEV:
    """An eval ``IGEVStereo`` with its GEV tower folded (see the module
    docstring).  Holds the model for the modules it runs unfolded."""

    def __init__(self, model: IGEVStereo):
        if model.training:
            raise ValueError("BatchNorm folding needs an eval-mode model")
        self.model = model
        ca = model.cost_agg
        self.corr_stem = fold_basic(model.corr_stem, SLOT, SLOT)
        self.att_corr = fold_att(model.corr_feature_att, SLOT)
        self.conv1_0 = fold_basic(ca.conv1[0], SLOT)
        self.conv1_1 = fold_basic(ca.conv1[1])
        self.conv2_0 = fold_basic(ca.conv2[0])
        self.conv2_1 = fold_basic(ca.conv2[1])
        self.conv3_0 = fold_basic(ca.conv3[0])
        self.conv3_1 = fold_basic(ca.conv3[1])
        self.conv3_up = fold_basic(ca.conv3_up)
        self.conv2_up = fold_basic(ca.conv2_up)
        self.conv1_up = fold_basic(ca.conv1_up, cout=SLOT)
        c3u = ca.conv3_up.conv.weight.shape[1]
        c2u = ca.conv2_up.conv.weight.shape[1]
        self.agg0_0, self.agg0_0_skip = _split(fold_basic(ca.agg_0[0]), c3u)
        self.agg0_1, self.agg0_2 = fold_basic(ca.agg_0[1]), fold_basic(ca.agg_0[2])
        self.agg1_0, self.agg1_0_skip = _split(fold_basic(ca.agg_1[0]), c2u)
        self.agg1_1, self.agg1_2 = fold_basic(ca.agg_1[1]), fold_basic(ca.agg_1[2])
        self.att = {name: fold_att(getattr(ca, f"feature_att_{name}"))
                    for name in ATT_LEVELS}
        self.classifier = _pad(model.classifier.weight.permute(2, 3, 4, 1, 0), None, SLOT)

    def gev_tower(self, match_l: torch.Tensor, match_r: torch.Tensor, feat_l: list):
        """``gev_tower_packed``: ``(gev (B, H4, W4, D, 8), cost (B, H4, W4,
        D))`` from the match descriptors and the feature pyramid."""
        m = self.model
        dt = m.dtype
        d = m.max_disp // 4
        b, _, h4, w4 = match_l.shape
        _check_geometry(d, h4, w4)
        att = {k: att_map(a, feat_l[ATT_LEVELS[k]], dt) for k, a in self.att.items()}
        x = gwc_volume_packed(match_l, match_r, d, GEV_GROUPS, SLOT)
        x = conv3d_fold_p(x, *self.corr_stem, act=LEAKY,
                          post_mul=att_map(self.att_corr, feat_l[0], dt))
        c1 = conv3d_fold_s2(x, *self.conv1_0, act=LEAKY)
        c1 = conv3d_fold_p(c1, *self.conv1_1, act=LEAKY, post_mul=att["8"])
        c2 = conv3d_fold_s2(c1, *self.conv2_0, act=LEAKY)
        c2 = conv3d_fold_p(c2, *self.conv2_1, act=LEAKY, post_mul=att["16"])
        c3 = conv3d_fold_s2(c2, *self.conv3_0, act=LEAKY)
        c3 = conv3d_fold_p(c3, *self.conv3_1, act=LEAKY, post_mul=att["32"])
        y = conv3d_fold_up(c3, *self.conv3_up, act=LEAKY)
        y = conv1x1_fold_p(y, *self.agg0_0, act=LEAKY,
                           residual=conv1x1_fold_p(c2, *self.agg0_0_skip))
        y = conv3d_fold_p(y, *self.agg0_1, act=LEAKY)
        y = conv3d_fold_p(y, *self.agg0_2, act=LEAKY, post_mul=att["up_16"])
        y = conv3d_fold_up(y, *self.conv2_up, act=LEAKY)
        y = conv1x1_fold_p(y, *self.agg1_0, act=LEAKY,
                           residual=conv1x1_fold_p(c1, *self.agg1_0_skip))
        y = conv3d_fold_p(y, *self.agg1_1, act=LEAKY)
        y = conv3d_fold_p(y, *self.agg1_2, act=LEAKY, post_mul=att["up_8"])
        gev = conv3d_fold_up(y, *self.conv1_up)
        cost = conv3d_fold_p(gev, *self.classifier)
        return unpack_hwdc(gev, 8).view(b, h4, w4, d, 8), unpack_hwdc(cost, 1)

    def encode(self, left: torch.Tensor, right: torch.Tensor) -> IGEVEncoding:
        """``IGEVStereo.encode`` with the folded tower."""
        return self.model.encode(left, right, self.gev_tower)

    def denoise(self, entry, latent: torch.Tensor, t: torch.Tensor, out_hw: tuple[int, int]):
        return self.model.denoise(entry, latent, t, out_hw)

    def denoise_ref(self, entry, latent: torch.Tensor, t: torch.Tensor, coords1: torch.Tensor):
        return self.model.denoise_ref(entry, latent, t, coords1)


def fold_igev(model: IGEVStereo) -> FoldedIGEV:
    """Fold ``model`` (eval) into a ``FoldedIGEV``."""
    with torch.no_grad():
        return FoldedIGEV(model)
