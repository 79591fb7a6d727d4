"""PCWNet backbone and its DiffuVolume variant.

Counterpart of ``diffuvolume_tpu/models/pcw.py`` (``PCWNet``:
``build_cost_volume``, ``refine``, ``denoise``, the baseline eval forward,
the training forward):
Mish activations, a feature pyramid to 1/32 with a group-wise volume at
each of 1/4 … 1/32 (with the concat volume beside it when
``use_concat_volume``, the default; without it, the registry's ``gwcnet-g``),
a multi-scale ``HourglassUp`` that fuses them, three Mish hourglasses, and a
full-resolution warp-correlation refinement.  Module names follow the
reference state dict (KITTI12 ``pwcnet_ddim.py``, the keys
``tools/weights.py:pcw_rules`` lists; without the concat volume the
feature extractor has no concat heads, as upstream ``PWCNet_G``), so its
checkpoints load with ``load_state_dict``.  Images enter as ``(B, H, W, 3)`` and disparities leave
as ``(B, H, W)``; inside, features are NCHW and volumes NCDHW.

The volume work runs on the port's kernels: each scale's volume is built by
``gwc_volume_packed`` (then permuted to NCDHW), the step's noise multiply by
``dhw_mul`` with one map, the head by ``fused_upsample_softargmin`` and the
renewal score against the refined disparity by ``fused_uncertainty_at``.
The 2-D and 3-D convolutions are PyTorch convolutions; ``models/pcw_fold.py``
runs the 3-D ones on the port's kernels, and a bfloat16 model's refinement
net too; ``layers.route_conv3d`` runs this path's eligible
3×3×3 convs on ``conv3d_packed``.  Eval runs one 2B trunk pass for
both views.  ``train_forward`` runs the differentiable plain ops (the
kernels have no backward) and one trunk pass a view.

Under ``parallel/volume_sharding.py`` ``forward`` and ``train_forward``
work on this rank's band of the quarter-resolution rows, as ACVNet's do:
the trunk runs whole, each scale's volume is built on that scale's band
(the H/4 band scaled, ``volume_sharding.level_band``), the 3-D layers
exchange halos (``models/layers.py``), and the heads return the band's
full-resolution rows.  The bands' edges fall on multiples of 8 rows at H/4
(``HourglassUp``'s three stride-2 levels).  The refinement is
full-resolution 2-D work over dilated convs: it runs whole on every rank
from the gathered ``pred3`` and keeps this rank's rows of its output.  The
eval head's resize maps corners to corners, which no halo and crop of a
band reproduces, so under the split it runs on the gathered logits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from diffuvolume_tpu_torch.diffusion import encode_disparity_volume, make_schedule, q_sample
from diffuvolume_tpu_torch.models.layers import (
    ACTS,
    BasicBlock,
    ConvBN,
    ConvTransposeBN,
    DynamicHead,
    HeadConv3D,
    conv3d_rows,
    convbn_3d,
    init_weights,
)
from diffuvolume_tpu_torch.ops.cost_volume import (
    build_concat_volume,
    build_gwc_volume,
    build_signed_correlation_volume,
)
from diffuvolume_tpu_torch.ops.kernels.concat_volume import dhw_mul
from diffuvolume_tpu_torch.ops.kernels.fused_head import (
    fused_uncertainty_at,
    fused_upsample_softargmin,
)
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume_packed
from diffuvolume_tpu_torch.ops.regression import at_least_f32, regress_head, resize_bilinear
from diffuvolume_tpu_torch.ops.sampling import warp_right_to_left
from diffuvolume_tpu_torch.parallel.volume_sharding import (
    constrain_volume,
    current_volume_spec,
    cut_rows,
    gather_rows,
)

# The refinement's signed correlation reaches ±24 px (pwcnet_ddim.py:486-502).
REFINE_MAX_OFFSET = 24
# The multiple of rows a band's edges fall on at H/4 under the volume
# split: HourglassUp's three stride-2 levels below it.
BAND_MULTIPLE = 8


class PCWEntry(NamedTuple):
    """The DDIM model's scan-invariant inputs to ``denoise``: the combine
    volume (``(B, 32, D, H4, W4)`` on the module path, ``(B, D, H4, W4, 32)``
    on the folded path) and the trunk features of both views, which the
    refinement reads."""

    volume: torch.Tensor
    fl: dict
    fr: dict


def _make_layer(in_ch, out_ch, blocks, stride, dilation, act) -> nn.Sequential:
    downsample = stride != 1 or in_ch != out_ch
    layers = [BasicBlock(in_ch, out_ch, stride, 1, dilation, downsample, act)]
    layers += [BasicBlock(out_ch, out_ch, 1, 1, dilation, act=act) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


def _head2d(in_ch, mid, out_ch, act) -> nn.Sequential:
    """``Sequential(convbn 3×3, act, Conv2d 1×1)``: the gw and concat heads."""
    return nn.Sequential(ConvBN(in_ch, mid, 3, 1, 1), ACTS[act](),
                         nn.Conv2d(mid, out_ch, 1, bias=False))


def _convbn3d_act(in_ch, out_ch, stride, act) -> nn.Sequential:
    return nn.Sequential(convbn_3d(in_ch, out_ch, 3, stride, 1), ACTS[act]())


class PCWFeatureExtractor(nn.Module):
    """Pyramid to 1/32 (pwcnet_ddim.py:12-128): ``(B, 3, H, W)`` → the gw
    features (320 channels at 1/4, 1/8, 1/16, 1/32), the concat features
    (``concat_channels`` at each; with 0 no concat heads and no such
    features) and the 32-channel refinement feature."""

    def __init__(self, concat_channels: int = 12, act: str = "mish"):
        super().__init__()
        a = ACTS[act]
        self.firstconv = nn.Sequential(
            ConvBN(3, 32, 3, 2, 1), a(), ConvBN(32, 32, 3, 1, 1), a(),
            ConvBN(32, 32, 3, 1, 1), a())
        self.layer1 = _make_layer(32, 32, 3, 1, 1, act)
        self.layer2 = _make_layer(32, 64, 16, 2, 1, act)
        self.layer3 = _make_layer(64, 128, 3, 1, 1, act)
        self.layer4 = _make_layer(128, 128, 3, 1, 2, act)
        self.layer5 = _make_layer(128, 192, 3, 2, 1, act)
        self.layer7 = _make_layer(192, 256, 3, 2, 1, act)
        self.layer9 = _make_layer(256, 512, 3, 2, 1, act)
        self.layer11 = _head2d(320, 320, 320, act)
        self.gw2 = _head2d(192, 320, 320, act)
        self.gw3 = _head2d(256, 320, 320, act)
        self.gw4 = _head2d(512, 320, 320, act)
        self.layer_refine = nn.Sequential(ConvBN(320, 128, 3, 1, 1), a(),
                                          ConvBN(128, 32, 1, 1, 0), a())
        if concat_channels:
            self.lastconv = _head2d(320, 128, concat_channels, act)
            self.concat2 = _head2d(192, 128, concat_channels, act)
            self.concat3 = _head2d(256, 128, concat_channels, act)
            self.concat4 = _head2d(512, 128, concat_channels, act)
        self.concat_channels = concat_channels

    def forward(self, x) -> dict[str, torch.Tensor]:
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        l5 = self.layer5(l4)
        l6 = self.layer7(l5)
        l7 = self.layer9(l6)
        combine = torch.cat([l2, l3, l4], dim=1)  # 320 channels at 1/4
        out = {"gw1": self.layer11(combine), "gw2": self.gw2(l5), "gw3": self.gw3(l6),
               "gw4": self.gw4(l7), "refine": self.layer_refine(combine)}
        if self.concat_channels:
            out.update(concat1=self.lastconv(combine), concat2=self.concat2(l5),
                       concat3=self.concat3(l6), concat4=self.concat4(l7))
        return out


class HourglassUp(nn.Module):
    """The multi-scale combining hourglass (pwcnet_ddim.py:131-205): strided
    3-D convs down to 1/32, each level fused with that scale's volume by a
    conv over the concatenation, transposed convs back up with skips.
    ``vol_ch``: each scale's volume's channels (2·ch by default)."""

    def __init__(self, ch: int, act: str = "mish", vol_ch: int | None = None):
        super().__init__()
        self.act = ACTS[act]()
        self.conv1 = nn.Conv3d(ch, 2 * ch, 3, 2, 1, bias=False)
        self.conv2 = _convbn3d_act(2 * ch, 2 * ch, 1, act)
        self.conv3 = nn.Conv3d(2 * ch, 4 * ch, 3, 2, 1, bias=False)
        self.conv4 = _convbn3d_act(4 * ch, 4 * ch, 1, act)
        self.conv5 = nn.Conv3d(4 * ch, 4 * ch, 3, 2, 1, bias=False)
        self.conv6 = _convbn3d_act(4 * ch, 4 * ch, 1, act)
        self.conv7 = ConvTransposeBN(4 * ch, 4 * ch)
        self.conv8 = ConvTransposeBN(4 * ch, 2 * ch)
        self.conv9 = ConvTransposeBN(2 * ch, ch)
        v = 2 * ch if vol_ch is None else vol_ch
        self.combine1 = _convbn3d_act(2 * ch + v, 2 * ch, 1, act)
        self.combine2 = _convbn3d_act(4 * ch + v, 4 * ch, 1, act)
        self.combine3 = _convbn3d_act(4 * ch + v, 4 * ch, 1, act)
        self.redir1 = convbn_3d(ch, ch, 1, 1, 0)
        self.redir2 = convbn_3d(2 * ch, 2 * ch, 1, 1, 0)
        self.redir3 = convbn_3d(4 * ch, 4 * ch, 1, 1, 0)

    def forward(self, x, feature4, feature5, feature6):
        conv1 = self.combine1(torch.cat([conv3d_rows(self.conv1, x), feature4], dim=1))
        conv2 = self.conv2(conv1)
        conv3 = self.combine2(torch.cat([conv3d_rows(self.conv3, conv2), feature5], dim=1))
        conv4 = self.conv4(conv3)
        conv5 = self.combine3(torch.cat([conv3d_rows(self.conv5, conv4), feature6], dim=1))
        conv6 = self.conv6(conv5)
        conv7 = self.act(self.conv7(conv6) + self.redir3(conv4))
        conv8 = self.act(self.conv8(conv7) + self.redir2(conv2))
        return self.act(self.conv9(conv8) + self.redir1(x))


class HourglassMish(nn.Module):
    """The plain hourglass without attention (pwcnet_ddim.py:208-248)."""

    def __init__(self, ch: int, act: str = "mish"):
        super().__init__()
        self.act = ACTS[act]()
        self.conv1 = _convbn3d_act(ch, 2 * ch, 2, act)
        self.conv2 = _convbn3d_act(2 * ch, 2 * ch, 1, act)
        self.conv3 = _convbn3d_act(2 * ch, 4 * ch, 2, act)
        self.conv4 = _convbn3d_act(4 * ch, 4 * ch, 1, act)
        self.conv5 = ConvTransposeBN(4 * ch, 2 * ch)
        self.conv6 = ConvTransposeBN(2 * ch, ch)
        self.redir1 = convbn_3d(ch, ch, 1, 1, 0)
        self.redir2 = convbn_3d(2 * ch, 2 * ch, 1, 1, 0)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c4 = self.conv4(self.conv3(c2))
        c5 = self.act(self.conv5(c4) + self.redir2(c2))
        return self.act(self.conv6(c5) + self.redir1(x))


class RefineNetV3(nn.Module):
    """Full-resolution dilated refinement net → residual disparity
    (pwcnet_ddim.py:251-306); input 146 channels."""

    def __init__(self, in_ch: int = 146, act: str = "mish"):
        super().__init__()
        a = ACTS[act]
        self.conv1 = nn.Sequential(ConvBN(in_ch, 128, 3, 1, 1), a())
        self.conv2 = nn.Sequential(ConvBN(128, 128, 3, 1, 1), a())
        self.conv3 = nn.Sequential(ConvBN(128, 128, 3, 1, 2, 2), a())
        self.conv4 = nn.Sequential(ConvBN(128, 128, 3, 1, 4, 4), a())
        self.conv5 = nn.Sequential(BasicBlock(128, 96, 1, 1, 8, True, act))
        self.conv6 = nn.Sequential(BasicBlock(96, 64, 1, 1, 16, True, act))
        self.conv7 = nn.Sequential(BasicBlock(64, 32, 1, 1, 1, True, act))
        self.conv8 = nn.Conv2d(32, 1, 3, 1, 1, bias=False)

    def forward(self, x, disp):
        for i in range(1, 9):
            x = getattr(self, f"conv{i}")(x)
        return disp + at_least_f32(x[:, 0])


def _classif(act) -> nn.Sequential:
    return nn.Sequential(convbn_3d(32, 32, 3, 1, 1), ACTS[act](), HeadConv3D(32))


class PCWNet(nn.Module):
    """PCWNet with multi-scale volume fusion, optionally with the
    DiffuVolume time embedding (``diffusion=True``).  Each scale's volume is
    the group-wise correlation (``num_groups`` channels), then with
    ``use_concat_volume`` the 12 + 12 concat channels (KITTI12's
    ``gwcnet-gc`` and ``pcwnet_ddim``); without it the correlation alone
    (``gwcnet-g``)."""

    def __init__(self, max_disp: int = 192, diffusion: bool = True, scale: float = 1.0,
                 num_groups: int = 40, act: str = "mish", use_concat_volume: bool = True):
        super().__init__()
        self.max_disp = max_disp
        self.diffusion = diffusion
        self.scale = scale
        self.num_groups = num_groups
        self.use_concat_volume = use_concat_volume
        self.concat_channels = 12 if use_concat_volume else 0
        self.act = act
        a = ACTS[act]
        vol_ch = num_groups + 2 * self.concat_channels
        self.feature_extraction = PCWFeatureExtractor(self.concat_channels, act)
        self.dres0 = nn.Sequential(convbn_3d(vol_ch, 32, 3, 1, 1), a(),
                                   convbn_3d(32, 32, 3, 1, 1), a())
        self.dres1 = nn.Sequential(convbn_3d(32, 32, 3, 1, 1), a(), convbn_3d(32, 32, 3, 1, 1))
        self.combine1 = HourglassUp(32, act, vol_ch)
        if diffusion:
            self.time_embedding = DynamicHead(max_disp // 4)
        self.dres2 = HourglassMish(32, act)
        self.dres3 = HourglassMish(32, act)
        self.dres4 = HourglassMish(32, act)
        for k in range(5):
            setattr(self, f"classif{k}", _classif(act))
        self.refinenet3 = RefineNetV3(act=act)
        self.dispupsample = nn.Sequential(ConvBN(1, 32, 1, 1, 0), a())

    def init_weights(self, generator: torch.Generator) -> "PCWNet":
        """Draw every weight from ``generator`` (see ``layers.init_weights``)."""
        init_weights(self, generator)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.classif3[2].weight.dtype

    # ---- volume construction (pwcnet_ddim.py:605-641) ----

    def features(self, left: torch.Tensor, right: torch.Tensor):
        """``(B, H, W, 3)`` images → ``(fl, fr)``: the trunk's feature dicts of
        both views, from one 2B pass, in the model's dtype."""
        b = left.shape[0]
        x = torch.cat([left, right], dim=0).to(self.dtype).permute(0, 3, 1, 2).contiguous()
        feat = self.feature_extraction(x)
        return ({k: v[:b].contiguous() for k, v in feat.items()},
                {k: v[b:].contiguous() for k, v in feat.items()})

    def volumes(self, fl: dict, fr: dict) -> list[torch.Tensor]:
        """The four scales' volumes ``(B, D_s, H_s, W_s, slot)`` channels-last,
        the slot ``slot_width`` of the volume's channels: group-wise
        correlation, then (with the concat volume, 40 + 12 + 12 in 64) the
        concat halves with the reference side zeroed where ``w < d`` too, as
        KITTI12's concat volume is; without it the 40 groups in 48."""
        md, g = self.max_disp, self.num_groups
        cc = self.concat_channels
        return [gwc_volume_packed(fl[f"gw{i}"], fr[f"gw{i}"], md // (4 << (i - 1)), g,
                                  cat_l=fl[f"concat{i}"] if cc else None,
                                  cat_r=fr[f"concat{i}"] if cc else None, mask_ref=True)
                for i in (1, 2, 3, 4)]

    @staticmethod
    def _cut(fl: dict) -> None:
        """Under the volume split, cut the H/4 rows into this forward's
        bands (every scale's band is that cut scaled)."""
        if current_volume_spec() is not None:
            cut_rows(fl["gw1"].shape[2], BAND_MULTIPLE)

    def build_cost_volume(self, left: torch.Tensor, right: torch.Tensor):
        """``(B, H, W, 3)`` images → ``(combine (B, 32, D, H4, W4), cost0, fl,
        fr)``: the fused multi-scale volume that the diffusion latent
        multiplies (this rank's band under the volume split)."""
        fl, fr = self.features(left, right)
        self._cut(fl)
        c = self.num_groups + 2 * self.concat_channels
        v1, v2, v3, v4 = (v[..., :c].permute(0, 4, 1, 2, 3).contiguous()
                          for v in self.volumes(fl, fr))
        cost0 = self.dres0(v1)
        cost0 = self.dres1(cost0) + cost0
        # NCDHW for dhw_mul: convs routed by route_conv3d leave their
        # outputs channels-last (a copy then; a no-op otherwise).
        combine = self.combine1(cost0, v2, v3, v4).contiguous()
        return combine, cost0, fl, fr

    # ---- heads and refinement ----

    def _head_cost(self, x: torch.Tensor) -> torch.Tensor:
        return self.classif3(x)[:, 0].float().contiguous()  # (B, D, H4, W4)

    def refine_input(self, pred3: torch.Tensor, fl: dict, fr: dict,
                     out_hw: tuple[int, int]) -> torch.Tensor:
        """The refinement net's input (pwcnet_ddim.py:486-502): both views'
        refinement features resized to ``out_hw``, the right one warped by
        ``pred3``, their difference, the left one, ``dispupsample(pred3)``,
        ``pred3`` and the signed correlation: ``(B, 146, H, W)`` in the
        model's dtype.  The resize, warp and correlation run in float32."""
        dt = self.dtype
        rl = resize_bilinear(at_least_f32(fl["refine"]), out_hw, 2, 3, align_corners=True)
        rr = resize_bilinear(at_least_f32(fr["refine"]), out_hw, 2, 3, align_corners=True)
        rr_warp = warp_right_to_left(rr, pred3)
        corr = build_signed_correlation_volume(rl, rr_warp, REFINE_MAX_OFFSET)
        p = pred3[:, None].to(dt)
        return torch.cat([(rl - rr_warp).to(dt), rl.to(dt), self.dispupsample(p), p, corr.to(dt)],
                         dim=1)  # 32 + 32 + 32 + 1 + 49 = 146 channels

    def refine(self, pred3: torch.Tensor, fl: dict, fr: dict, out_hw: tuple[int, int]):
        """Full-resolution warp + signed correlation refinement
        (pwcnet_ddim.py:486-502, 712-734): ``refine_input``, then the
        refinement convs in the model's dtype.  Returns the refined
        disparity ``(B, H, W)`` float32."""
        return self.refinenet3(self.refine_input(pred3, fl, fr, out_hw), at_least_f32(pred3))

    def embed_noise(self, latent: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The time-embedded latent clamped to ±scale and rescaled to [0, 1]."""
        noise = self.time_embedding(latent, t)
        noise = noise.clamp(-self.scale, self.scale)
        return (noise / self.scale + 1.0) / 2.0

    def _aggregate(self, volume: torch.Tensor, fl: dict, fr: dict, out_hw, want_unc: bool):
        out = self.dres4(self.dres3(self.dres2(volume)))
        cost3 = self._head_cost(out)
        if current_volume_spec() is not None:
            cost3 = gather_rows(cost3)
        pred3, _ = fused_upsample_softargmin(cost3, self.max_disp, out_hw, align_corners=True)
        disp = self.refine(pred3, fl, fr, out_hw)
        unc = (fused_uncertainty_at(cost3, disp, self.max_disp, out_hw, align_corners=True)
               if want_unc else None)
        return constrain_volume(disp), None if unc is None else constrain_volume(unc)

    # ---- diffusion-conditioned single pass (pwcnet_ddim.py:467-530) ----

    def denoise(self, entry: PCWEntry, latent: torch.Tensor, t: torch.Tensor,
                out_hw: tuple[int, int]):
        """Multiply the noisy latent's transform into the combine volume,
        aggregate, regress, refine, and score the uncertainty against the
        refined disparity (the reference's ``Σ|d − disp_finetune|·p3``).
        Returns ``(disp_finetune, unc, transformed)``, float32."""
        noise = self.embed_noise(latent, t)
        vol = dhw_mul(entry.volume, noise.to(entry.volume.dtype).contiguous(), None)
        disp, unc = self._aggregate(vol, entry.fl, entry.fr, out_hw, want_unc=True)
        return disp, unc, noise.float()

    # ---- training forward (pwcnet_ddim.py:604-758) ----

    def train_forward(self, left: torch.Tensor, right: torch.Tensor,
                      disp_gt_q: torch.Tensor | None = None, t: torch.Tensor | None = None,
                      noise: torch.Tensor | None = None) -> list[torch.Tensor]:
        """The JAX package's ``PCWNet.__call__(..., train=True)``: the six
        heads ``[pred0, comb_pred, pred1, pred2, pred3, disp_finetune]``
        (``(B, H, W)`` float32, KITTI12's loss weights in this order).  The
        diffusion model's inputs are ``ACVNet.train_forward``'s; the latent's
        transform multiplies the combine volume (whole inputs; under the
        volume split the heads are this rank's rows)."""
        out_hw = (left.shape[1], left.shape[2])
        dt = self.dtype
        fl = self.feature_extraction(left.to(dt).permute(0, 3, 1, 2).contiguous())
        fr = self.feature_extraction(right.to(dt).permute(0, 3, 1, 2).contiguous())
        self._cut(fl)
        def volume(i: int, d: int) -> torch.Tensor:
            gwc = build_gwc_volume(fl[f"gw{i}"], fr[f"gw{i}"], d, self.num_groups)
            if not self.use_concat_volume:
                return gwc
            return torch.cat([gwc, build_concat_volume(fl[f"concat{i}"], fr[f"concat{i}"], d,
                                                       mask_ref=True)], dim=1)

        v1, v2, v3, v4 = (volume(i, self.max_disp // (4 << (i - 1))) for i in (1, 2, 3, 4))
        cost0 = self.dres0(v1)
        cost0 = self.dres1(cost0) + cost0
        combine = self.combine1(cost0, v2, v3, v4)
        combine_in = combine
        if self.diffusion:
            x_start = encode_disparity_volume(constrain_volume(disp_gt_q), self.max_disp // 4,
                                              self.scale)
            noisy = q_sample(make_schedule(1000, device=x_start.device), x_start, t,
                             constrain_volume(noise))
            combine_in = combine * self.embed_noise(noisy, t)[:, None]

        def head(classif, x):
            return regress_head(classif(x)[:, 0], self.max_disp, out_hw, align_corners=True)

        out1 = self.dres2(combine_in)
        out2 = self.dres3(out1)
        out3 = self.dres4(out2)
        pred3 = head(self.classif3, out3)
        whole = gather_rows(pred3) if current_volume_spec() is not None else pred3
        disp_finetune = constrain_volume(self.refine(whole, fl, fr, out_hw))
        return [head(self.classif0, cost0), head(self.classif4, combine), head(self.classif1, out1),
                head(self.classif2, out2), pred3, disp_finetune]

    # ---- baseline eval forward ----

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """Eval forward: ``[disp_finetune (B, H, W)]`` from ``(B, H, W, 3)``
        images."""
        combine, _, fl, fr = self.build_cost_volume(left, right)
        disp, _ = self._aggregate(combine, fl, fr, (left.shape[1], left.shape[2]),
                                  want_unc=False)
        return [disp]
