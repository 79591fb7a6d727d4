"""ACVNet backbone and its DiffuVolume variant.

Counterpart of ``diffuvolume_tpu/models/acv.py`` (``ACVNet``:
``build_cost_volume``, ``denoise``, the baseline eval forward, the training
forward).  Module names
follow the reference state dict, so its checkpoints load with
``load_state_dict``.  Images enter as ``(B, H, W, 3)`` and disparities leave
as ``(B, H, W)``, the JAX package's layouts; inside, features are NCHW and
volumes NCDHW.

The eval volume work runs on the port's kernels: the group-wise correlation
volume (``gwc_volume``), the concat volume (``concat_volume``), the per-step
attention × noise multiply (``dhw_mul``) and the fused regression head
(``fused_upsample_softargmin``).  The 2-D and 3-D convolutions are PyTorch
convolutions.  The kernels have no backward, so ``train_forward`` runs the
differentiable plain ops instead (``ops/cost_volume.py``,
``ops/regression.py``), as the JAX package's training runs XLA's.

Under ``parallel/volume_sharding.py`` ``forward`` and ``train_forward``
work on this rank's band of the quarter-resolution rows: the trunk runs
whole, the volume builders keep the band, the 3-D layers exchange halos
(``models/layers.py``), and every head returns the band's full-resolution
rows.  The bands' edges fall on multiples of 4 rows at H/4 (the
hourglasses' two stride-2 levels; ``parallel/volume_sharding.py:edges``),
so a volume axis of at most H/16 splits every shape the unsplit model
takes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from diffuvolume_tpu_torch.diffusion import encode_disparity_volume, make_schedule, q_sample
from diffuvolume_tpu_torch.models.layers import (
    ACVFeatureExtractor,
    ConvBN,
    DynamicHead,
    HeadConv3D,
    HourglassACV,
    conv3d_rows,
    convbn_3d,
    init_weights,
)
from diffuvolume_tpu_torch.ops.cost_volume import build_concat_volume, build_gwc_volume
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume, dhw_mul
from diffuvolume_tpu_torch.ops.kernels.fused_head import fused_upsample_softargmin
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume
from diffuvolume_tpu_torch.ops.regression import regress_head, upsample_halo
from diffuvolume_tpu_torch.parallel.volume_sharding import (
    constrain_volume,
    current_volume_spec,
    cut_rows,
)

# The multiple of rows a band's edges fall on at H/4 under the volume
# split: two stride-2 levels below it.
BAND_MULTIPLE = 4


def fused_head_rows(cost: torch.Tensor, max_disp: int, out_hw: tuple[int, int]):
    """``fused_upsample_softargmin`` of ``(B, D4, H4, W4)`` logits; under the
    volume split on this rank's band with a replicated row a side
    (``upsample_halo``), keeping the band's full-resolution rows."""
    if current_volume_spec() is None:
        return fused_upsample_softargmin(cost.contiguous(), max_disp, out_hw)
    cost, h, rows = upsample_halo(cost, out_hw[0])
    disp, unc = fused_upsample_softargmin(cost.contiguous(), max_disp, (h, out_hw[1]))
    return disp[:, rows], unc[:, rows]


class ConcatEntry(NamedTuple):
    """The DDIM model's scan-invariant inputs to ``denoise``: the concat
    volume built without attention (``(B, 2C, D, H4, W4)`` on the module
    path, ``(B, D, H4, W4, 2C)`` on the folded path of ``models/acv_fold.py``),
    and the softmaxed attention ``(B, D, H4, W4)`` that each step multiplies
    in with its noise."""

    volume: torch.Tensor
    att: torch.Tensor


def _classif() -> nn.Sequential:
    return nn.Sequential(convbn_3d(32, 32, 3, 1, 1), nn.ReLU(inplace=True), HeadConv3D(32))


class ACVNet(nn.Module):
    """ACVNet with attention-filtered concat volume, optionally with the
    DiffuVolume time embedding (``diffusion=True``).  ``attn_weights_only``
    and ``freeze_attn_weights`` are the SceneFlow recipe's staged training
    (``train_forward``)."""

    def __init__(self, max_disp: int = 192, diffusion: bool = True, scale: float = 1.0,
                 num_groups: int = 40, concat_channels: int = 32,
                 attn_weights_only: bool = False, freeze_attn_weights: bool = False):
        super().__init__()
        self.max_disp = max_disp
        self.diffusion = diffusion
        self.scale = scale
        self.num_groups = num_groups
        self.attn_weights_only = attn_weights_only
        self.freeze_attn_weights = freeze_attn_weights
        relu = lambda: nn.ReLU(inplace=True)  # noqa: E731

        self.feature_extraction = ACVFeatureExtractor()
        self.concatconv = nn.Sequential(
            ConvBN(320, 128, 3, 1, 1), relu(),
            nn.Conv2d(128, concat_channels, 1, bias=False),
        )

        def patch_conv(ch, dil):
            return nn.Conv3d(ch, ch, (1, 3, 3), stride=1, padding=(0, dil, dil),
                             dilation=(1, dil, dil), groups=ch, bias=False)

        self.patch = patch_conv(num_groups, 1)
        self.patch_l1 = patch_conv(8, 1)
        self.patch_l2 = patch_conv(16, 2)
        self.patch_l3 = patch_conv(16, 3)
        self.dres1_att_ = nn.Sequential(
            convbn_3d(num_groups, 32, 3, 1, 1), relu(), convbn_3d(32, 32, 3, 1, 1))
        self.dres2_att_ = HourglassACV(32)
        self.classif_att_ = _classif()
        if diffusion:
            self.time_embedding = DynamicHead(max_disp // 4)
        self.dres0 = nn.Sequential(
            convbn_3d(2 * concat_channels, 32, 3, 1, 1), relu(),
            convbn_3d(32, 32, 3, 1, 1), relu())
        self.dres1 = nn.Sequential(
            convbn_3d(32, 32, 3, 1, 1), relu(), convbn_3d(32, 32, 3, 1, 1))
        self.dres2 = HourglassACV(32)
        self.dres3 = HourglassACV(32)
        self.classif0 = _classif()
        self.classif1 = _classif()
        self.classif2 = _classif()

    def init_weights(self, generator: torch.Generator) -> "ACVNet":
        """Draw every weight from ``generator`` (see ``layers.init_weights``)."""
        init_weights(self, generator)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.classif2[2].weight.dtype

    # ---- volume construction ----

    def trunk(self, left: torch.Tensor, right: torch.Tensor):
        """``(B, H, W, 3)`` images → the trunk features ``(B, 320, H4, W4)``
        of both views, in the model's dtype (whole; under the volume split
        the H/4 rows are cut into bands here)."""
        dt = self.dtype
        left = left.to(dt).permute(0, 3, 1, 2).contiguous()
        right = right.to(dt).permute(0, 3, 1, 2).contiguous()
        feat_l = self.feature_extraction(left).contiguous()
        if current_volume_spec() is not None:
            cut_rows(feat_l.shape[2], BAND_MULTIPLE)
        return feat_l, self.feature_extraction(right).contiguous()

    def features(self, left: torch.Tensor, right: torch.Tensor):
        """``(B, H, W, 3)`` images → ``(feat_l, feat_r, patch_volume)``: the
        trunk features ``(B, 320, H4, W4)`` and the GWC volume after the
        patch convs ``(B, G, D, H4, W4)``, in the model's dtype."""
        feat_l, feat_r = self.trunk(left, right)
        gwc = gwc_volume(feat_l, feat_r, self.max_disp // 4, self.num_groups)
        return feat_l, feat_r, self._patch(gwc)

    def _patch(self, gwc):
        gwc = conv3d_rows(self.patch, gwc)
        return torch.cat([
            conv3d_rows(self.patch_l1, gwc[:, :8]),
            conv3d_rows(self.patch_l2, gwc[:, 8:24]),
            conv3d_rows(self.patch_l3, gwc[:, 24:40]),
        ], dim=1)

    def concat_and_attention(self, feat_l, feat_r, att_weights):
        """``(cl, cr, att)`` from the trunk features and the attention
        logits ``(B, D, H4, W4)``: the concat features and the logits
        softmaxed over disparity, in the model's dtype."""
        cl = self.concatconv(feat_l).contiguous()
        cr = self.concatconv(feat_r).contiguous()
        att = torch.softmax(att_weights.float(), dim=1).to(self.dtype).contiguous()
        return cl, cr, att

    def build_cost_volume(self, left: torch.Tensor, right: torch.Tensor):
        """``(B, H, W, 3)`` images → ``(cl, cr, att)``: the concat features
        ``(B, C, H4, W4)`` and the attention softmaxed over disparity
        ``(B, D, H4, W4)`` in the model's dtype.  The JAX module path's
        ``ac_volume`` is ``att[:, None] · build_concat_volume(cl, cr, D)``."""
        feat_l, feat_r, patch_volume = self.features(left, right)
        att = self.dres2_att_(self.dres1_att_(patch_volume))
        att_weights = self.classif_att_(att)[:, 0]  # (B, D, H4, W4)
        return self.concat_and_attention(feat_l, feat_r, att_weights)

    # ---- aggregation and regression (eval: only the last head) ----

    def _aggregate_and_regress(self, volume: torch.Tensor, out_hw):
        cost0 = self.dres0(volume)
        cost0 = self.dres1(cost0) + cost0
        out2 = self.dres3(self.dres2(cost0))
        return fused_head_rows(self.classif2(out2)[:, 0].float(), self.max_disp, out_hw)

    # ---- diffusion-conditioned single pass ----

    def denoise(self, entry: ConcatEntry, latent: torch.Tensor, t: torch.Tensor,
                out_hw: tuple[int, int]):
        """Multiply the noisy latent's transform into the volume, aggregate,
        regress.  Returns ``(disp (B,H,W), unc (B,H,W), transformed
        (B,D,H4,W4))``, all float32; ``transformed`` is the time-embedded
        volume rescaled to [0, 1], which the sampler inverts from."""
        noise = self.embed_noise(latent, t)
        vol = dhw_mul(entry.volume, entry.att, noise.to(entry.att.dtype).contiguous())
        disp, unc = self._aggregate_and_regress(vol, out_hw)
        return disp, unc, noise.float()

    def embed_noise(self, latent: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The time-embedded latent clamped to ±scale and rescaled to [0, 1]."""
        noise = self.time_embedding(latent, t)
        noise = noise.clamp(-self.scale, self.scale)
        return (noise / self.scale + 1.0) / 2.0

    # ---- training forward (acv_ddim.py:424-482; acv.py:168-260) ----

    def _train_cost_volume(self, left, right):
        """``(ac_volume (B, 2C, D, H4, W4), att_weights (B, D, H4, W4))`` on
        the differentiable ops, the trunk run once a view."""
        feat_l, feat_r = self.trunk(left, right)
        patch_volume = self._patch(
            build_gwc_volume(feat_l, feat_r, self.max_disp // 4, self.num_groups))
        att_weights = self.classif_att_(self.dres2_att_(self.dres1_att_(patch_volume)))[:, 0]
        volume = build_concat_volume(self.concatconv(feat_l), self.concatconv(feat_r),
                                     self.max_disp // 4)
        return torch.softmax(att_weights, dim=1)[:, None] * volume, att_weights

    def train_forward(self, left: torch.Tensor, right: torch.Tensor,
                      disp_gt_q: torch.Tensor | None = None, t: torch.Tensor | None = None,
                      noise: torch.Tensor | None = None,
                      mask_gt: torch.Tensor | None = None) -> list[torch.Tensor]:
        """The JAX package's ``ACVNet.__call__(..., train=True)``: the heads
        ``[pred_att, pred0, pred1, pred2]`` (``(B, H, W)`` float32;
        ``[pred0, pred1, pred2]`` with ``freeze_attn_weights``, ``[pred_att]``
        with ``attn_weights_only``).  The diffusion model takes the
        quarter-res ground truth in bin units ``disp_gt_q (B, H4, W4)``, one
        timestep a sample ``t (B,)`` and the noise ``(B, D4, H4, W4)``:
        ``q_sample`` of the encoded ground truth, time-embedded, clamped and
        mapped to [0, 1], multiplies the volume (whole inputs; under the
        volume split the heads are this rank's rows).  With
        ``freeze_attn_weights`` no gradient reaches the cost volume's
        branch, but its BatchNorm statistics are updated, as under the JAX
        package's ``stop_gradient``."""
        out_hw = (left.shape[1], left.shape[2])
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_attn_weights):
            ac_volume, att_weights = self._train_cost_volume(left, right)

        def pred_att():
            return regress_head(att_weights, self.max_disp, out_hw)

        if self.attn_weights_only:
            return [pred_att()]
        if self.diffusion:
            if mask_gt is not None:
                mask_gt = constrain_volume(mask_gt)
            x_start = encode_disparity_volume(constrain_volume(disp_gt_q), self.max_disp // 4,
                                              self.scale, valid_mask=mask_gt)
            noisy = q_sample(make_schedule(1000, device=x_start.device), x_start, t,
                             constrain_volume(noise))
            ac_volume = ac_volume * self.embed_noise(noisy, t)[:, None]

        cost0 = self.dres0(ac_volume)
        cost0 = self.dres1(cost0) + cost0
        out1 = self.dres2(cost0)
        out2 = self.dres3(out1)
        pred2 = regress_head(self.classif2(out2)[:, 0], self.max_disp, out_hw)
        pred0 = regress_head(self.classif0(cost0)[:, 0], self.max_disp, out_hw)
        pred1 = regress_head(self.classif1(out1)[:, 0], self.max_disp, out_hw)
        if self.freeze_attn_weights:
            return [pred0, pred1, pred2]
        return [pred_att(), pred0, pred1, pred2]

    # ---- baseline eval forward ----

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """Eval forward: ``[disp (B, H, W)]`` from ``(B, H, W, 3)`` images."""
        out_hw = (left.shape[1], left.shape[2])
        cl, cr, att = self.build_cost_volume(left, right)
        vol = concat_volume(cl, cr, self.max_disp // 4, att=att)
        disp, _ = self._aggregate_and_regress(vol, out_hw)
        return [disp]
