"""IGEV-Stereo and its DiffuVolume variant.

Counterpart of ``diffuvolume_tpu/models/igev/model.py`` (``FeatureAtt``,
``HourglassGEV``, ``IGEVStereo``, ``igev_encode``, ``igev_rollout`` with
``test_mode=True`` in both noise modes, ``igev_rollout_ref_eval`` (the
reference-faithful eval's rollout), the eval ``igev_forward``; and the
training forward, ``igev_forward(..., train=True)``, as
``igev_train_forward``):
a MobileNetV2 trunk, an 8-group correlation volume aggregated by a
feature-attended 3-D hourglass into the Geometry Encoding Volume (GEV), a
three-level ConvGRU that refines the quarter-resolution disparity from
window lookups into the GEV and the all-pairs correlation, and superpixel
upsampling.  The DiffuVolume latent's transform multiplies the GEV before
the lookups, once per DDIM step.  Module names follow the reference state
dict (KITTI15 ``core/igev_stereo_ddim.py``), so its checkpoints load with
``load_state_dict``.

Images enter RAW in [0, 255] as ``(B, H, W, 3)``; disparities leave as
``(B, H, W)`` float32.  This module is the module path: the GEV tower on
cuDNN and BatchNorm, in ``channels_last_3d`` memory, with its 3×3×3 convs at
8 or 16 input channels on the port's kernel (``conv3d_fold_small``) and the
8-group volume on ``gwc_volume``; ``models/igev/gev_fold.py`` runs the whole
tower on the port's folded kernels.  The rollout's lookups, the GRU and the
upsampling are plain PyTorch on both paths.  The training forward runs
every op plain (the kernels have no backward): the volume on
``ops/cost_volume.py``, the convs on PyTorch's, the lookup on the dense
correlation (``corr_mode="volume"``, the JAX package's default).

Under ``parallel/volume_sharding.py`` the module path's encode and the
training encode build the GEV on this rank's band of the quarter-resolution
rows: the trunk runs whole, the 8-group volume, ``corr_stem``, its feature
attention and the hourglass work on the band (each level's band the H/4
band scaled; the attention's 2-D convs run on the whole trunk feature, then
the level's band is kept), with halos (``models/layers.py``).  The bands'
edges fall on multiples of 8 rows at H/4 (``HourglassGEV``'s three stride-2
levels).  The GEV (8 channels) is then gathered and everything after it
runs whole on every rank: the classifier, the initial disparity, the
lookup pyramid, the rollout and the upsampling; the forwards return this
rank's full-resolution rows.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffuvolume_tpu_torch.models.igev.extractor import (
    BasicConv,
    BasicConvIN,
    Conv2x,
    Feature,
    InstanceNorm,
    MultiBasicEncoder,
    channels_last,
    conv3x3x3_small,
)
from diffuvolume_tpu_torch.models.igev.geometry import (
    GeoPyramid,
    build_geo_pyramid,
    fold_reference_noise,
    geo_lookup,
    premultiply,
)
from diffuvolume_tpu_torch.models.igev.update import BasicMultiUpdateBlock
from diffuvolume_tpu_torch.models.layers import DynamicHead, init_weights
from diffuvolume_tpu_torch.ops.cost_volume import build_gwc_volume
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume
from diffuvolume_tpu_torch.ops.regression import at_least_f32
from diffuvolume_tpu_torch.ops.sampling import context_upsample
from diffuvolume_tpu_torch.parallel.volume_sharding import (
    constrain_volume,
    current_volume_spec,
    cut_rows,
    gather_rows,
)

GEV_GROUPS = 8
# The multiple of rows a band's edges fall on at H/4 under the volume
# split: HourglassGEV's three stride-2 levels below it.
BAND_MULTIPLE = 8


class IGEVEncoding(NamedTuple):
    """Everything the GRU rollout needs that does not change over the
    iterations: the match descriptors ``(B, 96, H4, W4)``, the GEV
    ``(B, H4, W4, D, 8)``, the initial disparity ``(B, H4, W4)`` float32, the
    GRU states and context biases, and the 1/2-resolution stem for the
    upsampling."""

    match_l: torch.Tensor
    match_r: torch.Tensor
    gev: torch.Tensor
    init_disp: torch.Tensor
    net_list: list
    inp_list: list
    stem_2x: torch.Tensor


class IGEVEntry(NamedTuple):
    """The DDIM model's loop-invariant inputs to ``denoise``: its encoding,
    the lookup pyramid and the GRU iterations a rollout runs."""

    enc: IGEVEncoding
    pyramid: GeoPyramid
    iters: int


class FeatureAtt(nn.Module):
    """Sigmoid feature attention over a cost volume, broadcast over D
    (``submodule.py:226-239``); under the volume split the attention of the
    whole feature, then the volume's band of it."""

    def __init__(self, cv_chan: int, feat_chan: int):
        super().__init__()
        self.feat_att = nn.Sequential(
            BasicConv(feat_chan, feat_chan // 2, kernel_size=1, stride=1, padding=0),
            nn.Conv2d(feat_chan // 2, cv_chan, 1))

    def forward(self, cv, feat):
        att = constrain_volume(torch.sigmoid(self.feat_att(feat)).unsqueeze(2))
        return channels_last(att * cv)


def _conv3d(cin, cout, stride):
    return BasicConv(cin, cout, is_3d=True, kernel_size=3, stride=stride, padding=1)


def _deconv3d(cin, cout, bn=True, relu=True):
    return BasicConv(cin, cout, deconv=True, is_3d=True, bn=bn, relu=relu, kernel_size=4,
                     stride=2, padding=1)


class HourglassGEV(nn.Module):
    """The feature-attended 3-D hourglass that turns the correlation volume
    into the GEV (``igev_stereo_ddim.py:24-89``)."""

    def __init__(self, ch: int = 8):
        super().__init__()
        self.conv1 = nn.Sequential(_conv3d(ch, 2 * ch, 2), _conv3d(2 * ch, 2 * ch, 1))
        self.conv2 = nn.Sequential(_conv3d(2 * ch, 4 * ch, 2), _conv3d(4 * ch, 4 * ch, 1))
        self.conv3 = nn.Sequential(_conv3d(4 * ch, 6 * ch, 2), _conv3d(6 * ch, 6 * ch, 1))
        self.conv3_up = _deconv3d(6 * ch, 4 * ch)
        self.conv2_up = _deconv3d(4 * ch, 2 * ch)
        self.conv1_up = _deconv3d(2 * ch, 8, bn=False, relu=False)
        self.agg_0 = nn.Sequential(
            BasicConv(8 * ch, 4 * ch, is_3d=True, kernel_size=1, stride=1, padding=0),
            _conv3d(4 * ch, 4 * ch, 1), _conv3d(4 * ch, 4 * ch, 1))
        self.agg_1 = nn.Sequential(
            BasicConv(4 * ch, 2 * ch, is_3d=True, kernel_size=1, stride=1, padding=0),
            _conv3d(2 * ch, 2 * ch, 1), _conv3d(2 * ch, 2 * ch, 1))
        self.feature_att_8 = FeatureAtt(2 * ch, 64)
        self.feature_att_16 = FeatureAtt(4 * ch, 192)
        self.feature_att_32 = FeatureAtt(6 * ch, 160)
        self.feature_att_up_16 = FeatureAtt(4 * ch, 192)
        self.feature_att_up_8 = FeatureAtt(2 * ch, 64)

    def forward(self, x, features):
        c1 = self.feature_att_8(self.conv1(x), features[1])
        c2 = self.feature_att_16(self.conv2(c1), features[2])
        c3 = self.feature_att_32(self.conv3(c2), features[3])
        c2 = self.agg_0(channels_last(torch.cat([self.conv3_up(c3), c2], dim=1)))
        c2 = self.feature_att_up_16(c2, features[2])
        c1 = self.agg_1(channels_last(torch.cat([self.conv2_up(c2), c1], dim=1)))
        c1 = self.feature_att_up_8(c1, features[1])
        return channels_last(self.conv1_up(c1))


def _stem(cin, c):
    return nn.Sequential(BasicConvIN(cin, c, kernel_size=3, stride=2, padding=1),
                         nn.Conv2d(c, c, 3, 1, 1, bias=False), InstanceNorm(), nn.ReLU())


class IGEVStereo(nn.Module):
    """IGEV-Stereo (``diffusion=False``: the frozen baseline) or its
    DiffuVolume variant (the time embedding, ``d_model`` 180 resized to
    ``max_disp // 4`` bins)."""

    def __init__(self, max_disp: int = 192, diffusion: bool = True,
                 hidden_dims=(128, 128, 128), n_gru_layers: int = 3, corr_levels: int = 2,
                 corr_radius: int = 4, scale: float = 1.0):
        super().__init__()
        self.max_disp = max_disp
        self.diffusion = diffusion
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.n_gru_layers = n_gru_layers
        self.scale = scale
        hd = tuple(hidden_dims)
        self.feature = Feature()
        self.cnet = MultiBasicEncoder(output_dim=(hd, hd))
        self.update_block = BasicMultiUpdateBlock(hd, n_gru_layers, corr_levels, corr_radius)
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1) for i in range(n_gru_layers))
        if diffusion:
            self.time_embedding = DynamicHead(180, out_bins=max_disp // 4)
        self.stem_2 = _stem(3, 32)
        self.stem_4 = _stem(32, 48)
        # spx, spx_2, spx_4: the training forward's init-disparity upsampling
        # (unused at eval).
        self.spx = nn.Sequential(nn.ConvTranspose2d(2 * 32, 9, 4, 2, 1))
        self.spx_2 = Conv2x(24, 32, deconv=True, norm="instance")
        self.spx_4 = nn.Sequential(BasicConvIN(96, 24, kernel_size=3, stride=1, padding=1),
                                   nn.Conv2d(24, 24, 3, 1, 1, bias=False), InstanceNorm(),
                                   nn.ReLU())
        self.spx_2_gru = Conv2x(32, 32, deconv=True, norm="batch")
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(2 * 32, 9, 4, 2, 1))
        self.conv = BasicConvIN(96, 96, kernel_size=3, stride=1, padding=1)
        self.desc = nn.Conv2d(96, 96, 1)
        self.corr_stem = BasicConv(8, 8, is_3d=True, kernel_size=3, stride=1, padding=1)
        self.corr_feature_att = FeatureAtt(8, 96)
        self.cost_agg = HourglassGEV(8)
        self.classifier = nn.Conv3d(8, 1, 3, 1, 1, bias=False)

    def init_weights(self, generator: torch.Generator) -> "IGEVStereo":
        """Draw every weight from ``generator`` (see ``layers.init_weights``)."""
        init_weights(self, generator)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.desc.weight.dtype

    # ---- the encode (igev_stereo_ddim.py:366-402) ----

    def trunk(self, left: torch.Tensor, right: torch.Tensor):
        """``(B, H, W, 3)`` RAW images → ``(feat_l, match_l, match_r, stem_2x,
        left_n)``: both views through the trunk as one 2B batch (per-sample
        arithmetic, so the same as two calls), the left view's feature
        pyramid, the match descriptors, the left 1/2 stem and the normalised
        left image (NCHW, the model's dtype)."""
        b = left.shape[0]
        im = torch.cat([left, right], dim=0).float().permute(0, 3, 1, 2)
        im = (2.0 * (im / 255.0) - 1.0).to(self.dtype).contiguous()
        feat = self.feature(im)
        stem_2 = self.stem_2(im)
        stem_4 = self.stem_4(stem_2)
        feat0 = torch.cat([feat[0], stem_4], dim=1)  # 96 channels at 1/4
        match = self.desc(self.conv(feat0))
        feat_l = [feat0[:b]] + [f[:b] for f in feat[1:]]
        return feat_l, match[:b], match[b:], stem_2[:b], im[:b]

    def context(self, left_n: torch.Tensor):
        """The GRU's initial states (tanh of the hidden heads) and context
        biases ``(cz, cr, cq)`` per level."""
        cnet = self.cnet(left_n)
        net_list = [torch.tanh(h) for h, _ in cnet]
        inp_list = [tuple(conv(torch.relu(ctx)).chunk(3, dim=1))
                    for conv, (_, ctx) in zip(self.context_zqr_convs, cnet)]
        return net_list, inp_list

    def _gev(self, volume, match_l, feat_l):
        """The GEV ``(B, 8, D, H4, W4)`` from ``volume()``, the 8-group
        volume; under the volume split built on this rank's band, then
        gathered."""
        split = current_volume_spec() is not None
        if split:
            cut_rows(match_l.shape[2], BAND_MULTIPLE)
        gev = self.cost_agg(self.corr_feature_att(self.corr_stem(volume()), feat_l[0]), feat_l)
        return channels_last(gather_rows(gev)) if split else gev

    def gev_tower(self, match_l, match_r, feat_l):
        """The module path's GEV tower: the 8-group volume (``gwc_volume``),
        ``corr_stem`` with its feature attention, the hourglass, the
        classifier.  Returns ``(gev (B, H4, W4, D, 8), cost (B, H4, W4, D))``."""
        gev = self._gev(lambda: channels_last(
            gwc_volume(match_l, match_r, self.max_disp // 4, GEV_GROUPS)), match_l, feat_l)
        cost = conv3x3x3_small(gev, self.classifier.weight)[:, 0]
        return gev.permute(0, 3, 4, 2, 1).contiguous(), cost.permute(0, 2, 3, 1)

    def encode(self, left: torch.Tensor, right: torch.Tensor, tower=None) -> IGEVEncoding:
        """Everything iteration-independent; ``tower`` replaces
        ``gev_tower`` (the folded path's)."""
        feat_l, match_l, match_r, stem_2x, left_n = self.trunk(left, right)
        gev, cost = (tower or self.gev_tower)(match_l, match_r, feat_l)
        return IGEVEncoding(match_l, match_r, gev, regress(cost), *self.context(left_n),
                            stem_2x)

    def train_encode(self, left: torch.Tensor, right: torch.Tensor):
        """The training encode (``encode(train=True)``): each view through
        the trunk on its own (BatchNorm's batch statistics are a view's, as
        the reference's), the GEV tower on the differentiable ops, and the
        superpixel weights of the initial disparity's upsampling.  Returns
        ``(IGEVEncoding, spx_pred (B, 9, H, W) float32)``."""
        def norm(x):
            return (2.0 * (at_least_f32(x).permute(0, 3, 1, 2) / 255.0) - 1.0).to(self.dtype)

        left_n, right_n = norm(left).contiguous(), norm(right).contiguous()
        feat_l, feat_r = self.feature(left_n), self.feature(right_n)
        stem_2x = self.stem_2(left_n)
        stem_4x = self.stem_4(stem_2x)
        stem_4y = self.stem_4(self.stem_2(right_n))
        feat_l[0] = torch.cat([feat_l[0], stem_4x], dim=1)  # 96 channels at 1/4
        feat_r[0] = torch.cat([feat_r[0], stem_4y], dim=1)
        match_l, match_r = self.desc(self.conv(feat_l[0])), self.desc(self.conv(feat_r[0]))

        gev = self._gev(lambda: channels_last(
            build_gwc_volume(match_l, match_r, self.max_disp // 4, GEV_GROUPS)), match_l, feat_l)
        cost = F.conv3d(gev, self.classifier.weight, padding=1)[:, 0]
        init_disp = regress(cost.permute(0, 2, 3, 1))
        net_list, inp_list = self.context(left_n)
        spx_pred = torch.softmax(at_least_f32(self.spx(self.spx_2(self.spx_4(feat_l[0]),
                                                                   stem_2x))), dim=1)
        enc = IGEVEncoding(match_l, match_r, gev.permute(0, 3, 4, 2, 1).contiguous(), init_disp,
                           net_list, inp_list, stem_2x)
        return enc, spx_pred

    # ---- one GRU step, the upsampling, the noise embedding ----

    def update(self, net_list, inp_list, geo_feat, disp):
        """One GRU update (``update.py:121-142``): ``geo_feat (B, H4, W4, F)``,
        ``disp (B, H4, W4)`` float32 → ``(net_list, mask_feat_4, delta (B,
        H4, W4) float32)``."""
        dt = self.dtype
        net_list, mask_feat, delta = self.update_block(
            net_list, inp_list, geo_feat.permute(0, 3, 1, 2).to(dt), disp[:, None].to(dt))
        return net_list, mask_feat, at_least_f32(delta[:, 0])

    def upsample(self, disp, mask_feat_4, stem_2x):
        """Superpixel ×4 upsampling (``igev_stereo_ddim.py:203-211``) of the
        quarter-res ``disp (B, H4, W4)`` → ``(B, H, W)`` float32."""
        xspx = self.spx_2_gru(mask_feat_4, stem_2x)
        spx_pred = torch.softmax(at_least_f32(self.spx_gru(xspx)), dim=1)
        return context_upsample(at_least_f32(disp) * 4.0, spx_pred)

    def embed_noise(self, noisy: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The time-embedded latent clamped to ±scale and mapped to [0, 1]
        (``igev_stereo_ddim.py:228-231``), float32."""
        y = at_least_f32(self.time_embedding(at_least_f32(noisy), t))
        y = y.clamp(-self.scale, self.scale)
        return (y / self.scale + 1.0) / 2.0

    def embed_noise_train(self, noisy: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The training variant of ``embed_noise``: ``t/1000`` is added
        before the clamp (``igev_stereo_ddim.py:433``)."""
        y = at_least_f32(self.time_embedding(at_least_f32(noisy), t))
        y = y + (t.to(y.dtype) / 1000.0)[:, None, None, None]
        y = y.clamp(-self.scale, self.scale)
        return (y / self.scale + 1.0) / 2.0

    def denoise(self, entry: IGEVEntry, latent: torch.Tensor, t: torch.Tensor,
                out_hw: tuple[int, int]):
        """One DDIM step's model call: the GRU rollout with the latent's
        transform in the GEV.  Returns ``(disp (B, H, W), zeros, transformed
        (B, D, H4, W4))``, float32: KITTI15's sampler has no uncertainty
        term (``eval/pipeline.py:422-429`` of the JAX package)."""
        disp = igev_rollout(self, entry.enc, entry.pyramid, entry.iters, latent, t)
        return disp, torch.zeros_like(disp), self.embed_noise(latent, t)

    def denoise_ref(self, entry: IGEVEntry, latent: torch.Tensor, t: torch.Tensor,
                    coords1: torch.Tensor):
        """The reference-faithful eval's model call (``quirk=True``):
        ``igev_rollout_ref_eval`` from the carried ``coords1 (B, H4, W4)``.
        Returns ``(residual (B, H, W), zeros, transformed (B, D, H4, W4),
        coords1)``, float32, the sampler's ``denoise_aux_init`` form."""
        resid_up, coords1 = igev_rollout_ref_eval(self, entry.enc, entry.pyramid, entry.iters,
                                                  coords1, latent, t)
        return resid_up, torch.zeros_like(resid_up), self.embed_noise(latent, t), coords1


def regress(cost: torch.Tensor) -> torch.Tensor:
    """The initial disparity: softmax over D of the classifier's cost
    ``(B, H4, W4, D)`` and its expectation, float32 ``(B, H4, W4)``."""
    prob = torch.softmax(at_least_f32(cost), dim=-1)
    return prob @ torch.arange(cost.shape[-1], dtype=prob.dtype, device=cost.device)


def module_of(model) -> IGEVStereo:
    """The ``IGEVStereo`` behind a model or its ``FoldedIGEV``."""
    return model if isinstance(model, IGEVStereo) else model.model


def igev_encode(model, left: torch.Tensor, right: torch.Tensor,
                corr_mode: str = "band") -> tuple[IGEVEncoding, GeoPyramid]:
    """The encode and the lookup pyramid (``igev_encode``) in ``corr_mode``
    (``geometry.CORR_MODES``); ``model`` is an ``IGEVStereo`` (module path)
    or a ``FoldedIGEV``."""
    enc = model.encode(left, right)
    return enc, build_geo_pyramid(enc.match_l, enc.match_r, enc.gev,
                                  module_of(model).corr_levels, corr_mode=corr_mode)


def _coords(enc: IGEVEncoding) -> torch.Tensor:
    b, h4, w4 = enc.init_disp.shape
    return torch.arange(w4, dtype=torch.float32, device=enc.init_disp.device).expand(b, h4, w4)


def igev_rollout(model, enc: IGEVEncoding, pyramid: GeoPyramid, iters: int,
                 noisy: torch.Tensor | None = None, t: torch.Tensor | None = None,
                 noise_mode: str = "pixel") -> torch.Tensor:
    """The eval GRU loop (``igev_rollout``, ``test_mode=True``): ``iters``
    updates from the initial disparity, only the last upsampled.  With
    ``noisy (B, D, H4, W4)`` and ``t (B,)`` the latent's transform enters
    the lookups, once per call: ``noise_mode="pixel"`` multiplies it into
    the GEV per pixel and bin; ``"ref"`` folds it as the reference does
    (``fold_reference_noise``: the reshape scramble, the noise pooled apart
    from the GEV) into the lookup's weights.  Returns ``(B, H, W)``
    float32."""
    m = module_of(model)
    coords = _coords(enc)
    noise_eff = None
    if noisy is not None:
        noise_mod = m.embed_noise(noisy, t)
        if noise_mode == "ref":
            noise_eff = fold_reference_noise(noise_mod, m.corr_levels)
        elif noise_mode == "pixel":
            pyramid = premultiply(pyramid, noise_mod)
        else:
            raise ValueError(f"noise_mode must be 'pixel' or 'ref', got {noise_mode!r}")
    disp, net_list, mask_feat = enc.init_disp, enc.net_list, None
    for _ in range(iters):
        geo = geo_lookup(pyramid, disp, coords, m.corr_radius, noise_eff)
        net_list, mask_feat, delta = m.update(net_list, enc.inp_list, geo, disp)
        disp = disp + delta
    return m.upsample(disp, mask_feat, enc.stem_2x)


def igev_rollout_ref_eval(model, enc: IGEVEncoding, pyramid: GeoPyramid, iters: int,
                          coords1: torch.Tensor, noisy: torch.Tensor,
                          t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference-faithful KITTI15 eval rollout (``igev_rollout_ref_eval``).

    The reference's sampler seeds ``coords0 = coords1 = init_disp``
    (``igev_stereo_ddim.py:425,313``) and its model iterates on ``flow =
    coords1 − coords0``: the GEV is sampled at the accumulated residual, the
    correlation at ``coords1 − flow = init_disp`` (constant), the update
    block takes the residual, and the step's output is the upsampled
    residual (``model_predictions:226-265``); ``coords1`` carries over to
    the next DDIM step.  The noise enters as ``noise_mode="ref"``.

    Args:
      coords1: ``(B, H4, W4)`` carried state (``init_disp`` at the start).
      noisy: ``(B, D, H4, W4)`` latent; t: ``(B,)`` timestep.

    Returns ``(resid_up (B, H, W), coords1 (B, H4, W4))``, float32.
    """
    m = module_of(model)
    coords0 = enc.init_disp
    noise_eff = fold_reference_noise(m.embed_noise(noisy, t), m.corr_levels)
    c1, net_list, mask_feat = coords1, enc.net_list, None
    for _ in range(iters):
        flow = c1 - coords0
        geo = geo_lookup(pyramid, flow, c1, m.corr_radius, noise_eff)
        net_list, mask_feat, delta = m.update(net_list, enc.inp_list, geo, flow)
        c1 = c1 + delta
    return m.upsample(c1 - coords0, mask_feat, enc.stem_2x), c1


def igev_forward(model, left: torch.Tensor, right: torch.Tensor, iters: int = 32,
                 noisy: torch.Tensor | None = None, t: torch.Tensor | None = None,
                 noise_mode: str = "pixel", corr_mode: str = "band") -> torch.Tensor:
    """The eval forward (``igev_forward``, ``test_mode=True``): encode, then
    ``iters`` GRU updates, then one upsampling → ``(B, H, W)``; this rank's
    rows under the volume split (the module path's)."""
    enc, pyramid = igev_encode(model, left, right, corr_mode)
    return constrain_volume(igev_rollout(model, enc, pyramid, iters, noisy, t, noise_mode))


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module`` in eval mode for the block (its BatchNorms on their running
    statistics, flax's ``train=False`` for one call), then back."""
    mode = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(mode)


def igev_train_rollout(model: IGEVStereo, enc: IGEVEncoding, pyramid: GeoPyramid, iters: int,
                       noisy: torch.Tensor | None = None,
                       t: torch.Tensor | None = None) -> torch.Tensor:
    """The training GRU loop (``igev_rollout(train=True)``): every iterate
    upsampled, the upsampling's BatchNorms frozen (the reference's
    freeze_bn, train_stereo.py:142,198-201), gradients through the whole
    loop; with ``noisy``/``t`` the latent's training transform
    (``embed_noise_train``) multiplies the GEV once.  Returns ``(iters, B,
    H, W)`` float32."""
    coords = _coords(enc)
    if noisy is not None:
        pyramid = premultiply(pyramid, model.embed_noise_train(noisy, t))
    disp, net_list, ups = enc.init_disp, enc.net_list, []
    with frozen(model.spx_2_gru):
        for _ in range(iters):
            geo = geo_lookup(pyramid, disp, coords, model.corr_radius)
            net_list, mask_feat, delta = model.update(net_list, enc.inp_list, geo, disp)
            disp = disp + delta
            ups.append(model.upsample(disp, mask_feat, enc.stem_2x))
    return torch.stack(ups)


def igev_train_forward(model: IGEVStereo, left: torch.Tensor, right: torch.Tensor,
                       iters: int = 22, noisy: torch.Tensor | None = None,
                       t: torch.Tensor | None = None):
    """The training forward (``igev_forward(train=True)``): ``(init_up (B,
    H, W), disp_ups (iters, B, H, W))``, float32.  ``model`` is in training
    mode; the encode's BatchNorms run on batch statistics, the rollout's
    frozen.  Under the volume split both are this rank's rows (the noise
    whole: it multiplies the gathered GEV)."""
    enc, spx_pred = model.train_encode(left, right)
    pyramid = build_geo_pyramid(enc.match_l, enc.match_r, enc.gev, model.corr_levels,
                                corr_mode="volume")
    disp_ups = igev_train_rollout(model, enc, pyramid, iters, noisy, t)
    return (constrain_volume(context_upsample(enc.init_disp * 4.0, spx_pred)),
            constrain_volume(disp_ups))


class DisparityTrack:
    """What ``track_disparity`` saw: the lowest and highest quarter-res
    disparity that entered or left a GRU update, the largest move from the
    first disparity seen, and the updates counted."""

    def __init__(self):
        self.lo, self.hi, self.max_drift, self.updates = math.inf, -math.inf, 0.0, 0
        self.first = None

    def see(self, disp: torch.Tensor) -> None:
        if self.first is None:
            self.first = disp
        self.lo = min(self.lo, float(disp.min()))
        self.hi = max(self.hi, float(disp.max()))
        self.max_drift = max(self.max_drift, float((disp - self.first).abs().max()))


@contextlib.contextmanager
def track_disparity(*models):
    """Record, on every GRU update of ``models`` (``IGEVStereo``s or their
    folds), the disparity before the update and after it: yields a
    ``DisparityTrack``.  ``max_drift`` is measured from the first rollout's
    initial disparity, so it means a move only over one rollout."""
    track = DisparityTrack()

    def hook(_, inputs, outputs):
        disp = inputs[3].float()[:, 0]
        track.see(disp)
        track.see(disp + outputs[2].float()[:, 0])
        track.updates += 1

    handles = [module_of(m).update_block.register_forward_hook(hook) for m in models]
    try:
        yield track
    finally:
        for h in handles:
            h.remove()

