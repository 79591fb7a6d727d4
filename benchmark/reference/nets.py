"""Plain PyTorch ACVNet and PCWNet, the benchmark's frozen reference.

A rewrite of the networks of iSEE-Laboratory/DiffuVolume (SceneFlow
``models/acv_ddim.py``, KITTI12 ``models/pwcnet_ddim.py``) in float32 with
no custom kernel: every volume is built by indexing, every head is
``F.interpolate`` + softmax + soft-argmin, BatchNorm stays a BatchNorm (no
folding), and the volumes stay NCDHW.  Module and parameter names are the
reference state dict's, so one state dict loads into these modules and into
the measured program's.  Images enter as ``(B, H, W, 3)``, disparities
leave as ``(B, H, W)``.

Nothing here imports the measured program: the benchmark judges the
program by this code, so it has to stand apart from it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# ---------------------------------------------------------------- layers


def act(name: str) -> nn.Module:
    return {"relu": lambda: nn.ReLU(), "mish": nn.Mish}[name]()


class ConvBN(nn.Sequential):
    """``Sequential(conv without bias, BatchNorm)``; padding per axis is the
    dilation where it is above 1, else ``pad`` (the reference's ``convbn``)."""

    def __init__(self, cin, cout, k, stride=1, pad=0, dilation=1, dims=2):
        conv_t, bn_t = (nn.Conv2d, nn.BatchNorm2d) if dims == 2 else (nn.Conv3d, nn.BatchNorm3d)
        padding = dilation if dilation > 1 else pad
        super().__init__(conv_t(cin, cout, k, stride, padding, dilation, bias=False), bn_t(cout))


def convbn3d(cin, cout, k, stride, pad) -> ConvBN:
    return ConvBN(cin, cout, k, stride, pad, dims=3)


class DeconvBN(nn.Sequential):
    """``ConvTranspose3d(k3, s2, p1, op1)`` without bias, then BatchNorm3d."""

    def __init__(self, cin, cout):
        super().__init__(nn.ConvTranspose3d(cin, cout, 3, 2, 1, 1, bias=False),
                         nn.BatchNorm3d(cout))


def head3d() -> nn.Conv3d:
    return nn.Conv3d(32, 1, 3, 1, 1, bias=False)


class BasicBlock(nn.Module):
    """2-D residual block: ``conv2(act(conv1(x))) + downsample(x)``."""

    def __init__(self, cin, cout, stride, pad, dilation, downsample, a):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBN(cin, cout, 3, stride, pad, dilation), act(a))
        self.conv2 = ConvBN(cout, cout, 3, 1, pad, dilation)
        self.downsample = ConvBN(cin, cout, 1, stride, 0) if downsample else None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


def make_layer(cin, cout, blocks, stride, dilation, a) -> nn.Sequential:
    first = BasicBlock(cin, cout, stride, 1, dilation, stride != 1 or cin != cout, a)
    return nn.Sequential(first, *[BasicBlock(cout, cout, 1, 1, dilation, False, a)
                                  for _ in range(blocks - 1)])


class WindowAttention3D(nn.Module):
    """Multi-head self-attention within (4, 4, 4) windows of a ``(B, C, D, H,
    W)`` volume; H and W zero-padded to the window, attention across the pad
    edge penalised by −1000; then the 1×1×1 ``final1x1``."""

    def __init__(self, ch, heads=16):
        super().__init__()
        self.heads = heads
        self.qkv_3d = nn.Linear(ch, 3 * ch)
        self.final1x1 = nn.Conv3d(ch, ch, 1)

    def forward(self, x):
        b, c, d, h0, w0 = x.shape
        ph, pw = -h0 % 4, -w0 % 4
        xp = F.pad(x, (0, pw, 0, ph)).permute(0, 2, 3, 4, 1)
        h, w = h0 + ph, w0 + pw
        nd, nh, nw = d // 4, h // 4, w // 4
        win = xp.reshape(b, nd, 4, nh, 4, nw, 4, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        win = win.reshape(b, nd * nh * nw, 64, c)
        q, k, v = self.qkv_3d(win).reshape(b, -1, 64, 3, self.heads, c // self.heads).unbind(3)
        q, k, v = (t.transpose(2, 3) for t in (q, k, v))  # (b, n, heads, 64, c/heads)
        logits = q @ k.transpose(-1, -2) * (c // self.heads) ** -0.5
        if ph or pw:
            flag = torch.zeros(h, w, device=x.device)
            flag[h0:] = 1.0
            flag[:, w0:] = 1.0
            f = flag.reshape(nh, 4, nw, 4).permute(0, 2, 1, 3).reshape(nh * nw, 16)
            pen = torch.where(f[:, None, :] != f[:, :, None], -1000.0, 0.0)
            logits = logits + pen.repeat(nd, 4, 4)[None, :, None]
        out = torch.softmax(logits, -1) @ v
        out = out.transpose(2, 3).reshape(b, nd, nh, nw, 4, 4, 4, c)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)[:, :, :h0, :w0]
        out = out @ self.final1x1.weight.flatten(1).t() + self.final1x1.bias
        return out.permute(0, 4, 1, 2, 3)


class TimeHead(nn.Module):
    """The DDIM time embedding: a sinusoid of ``t`` through two MLPs gives a
    per-bin shift added to the ``(B, D, H, W)`` latent."""

    def __init__(self, bins):
        super().__init__()
        self.bins = bins
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(bins, 4 * bins), nn.GELU(),
                                      nn.Linear(4 * bins, 4 * bins))
        self.block_time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(4 * bins, bins))

    def forward(self, latent, t):
        half = self.bins // 2
        freq = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                         * -(math.log(10000.0) / (half - 1)))
        ang = t.float()[:, None] * freq
        emb = torch.cat([ang.sin(), ang.cos()], -1).to(self.time_mlp[1].weight.dtype)
        return latent + self.block_time_mlp(self.time_mlp(emb))[:, :, None, None]


# ---------------------------------------------------------------- volumes


def gwc_volume(fl, fr, d, groups):
    """``vol[b, g, k, h, w] = mean_{c in g} fl[b,c,h,w]·fr[b,c,h,w-k]``, 0 for w < k."""
    b, c, h, w = fl.shape
    vol = fl.new_zeros(b, groups, d, h, w)
    for k in range(d):
        prod = fl[..., k:] * fr[..., :w - k]
        vol[:, :, k, :, k:] = prod.reshape(b, groups, c // groups, h, w - k).mean(2)
    return vol


def concat_volume(fl, fr, d, mask_ref=False):
    """``[fl (at every k; with mask_ref only where w >= k), fr shifted by k]``."""
    b, c, h, w = fl.shape
    vol = fl.new_zeros(b, 2 * c, d, h, w)
    for k in range(d):
        vol[:, :c, k, :, k if mask_ref else 0:] = fl[..., k if mask_ref else 0:]
        vol[:, c:, k, :, k:] = fr[..., :w - k]
    return vol


def signed_correlation(fl, fr, r):
    """Mean over channels of ``fl·fr`` shifted by ``k`` in ``-r..r`` px, 0 outside."""
    b, _, h, w = fl.shape
    vol = fl.new_zeros(b, 2 * r + 1, h, w)
    for i, k in enumerate(range(-r, r + 1)):
        if k >= 0:
            vol[:, i, :, k:] = (fl[..., k:] * fr[..., :w - k]).mean(1)
        else:
            vol[:, i, :, :k] = (fl[..., :k] * fr[..., -k:]).mean(1)
    return vol


def warp_to_left(feat, disp):
    """Right features warped by the left disparity, as KITTI12's
    ``submodule.py`` warps: the grid normalised by W−1 and H−1 but sampled
    with ``align_corners=False``, zero padding, and every output whose
    warped mask of ones is under 0.999 set to 0."""
    b, _, h, w = feat.shape
    xs = torch.arange(w, device=disp.device, dtype=disp.dtype) - disp
    ys = torch.arange(h, device=disp.device, dtype=disp.dtype)[:, None].expand(b, h, w)
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)
    out = F.grid_sample(feat, grid, align_corners=False)
    mask = F.grid_sample(torch.ones_like(feat[:, :1]), grid, align_corners=False)
    return out * (mask >= 0.999)


# ---------------------------------------------------------------- heads


def head_probs(cost, max_disp, hw, align_corners=False):
    """``(B, D4, H4, W4)`` logits → softmax over the trilinear upsample
    ``(B, max_disp, H, W)``."""
    up = F.interpolate(cost.float()[:, None], (max_disp, *hw), mode="trilinear",
                       align_corners=align_corners)[:, 0]
    return torch.softmax(up, 1)


def soft_argmin(prob):
    d = torch.arange(prob.shape[1], device=prob.device, dtype=prob.dtype)
    return (prob * d[:, None, None]).sum(1)


def spread_at(prob, disp):
    """``sum_d p(d)·|d − disp|``, the sampler's renewal uncertainty."""
    d = torch.arange(prob.shape[1], device=prob.device, dtype=prob.dtype)
    return (prob * (d[:, None, None] - disp[:, None]).abs()).sum(1)


def regress(cost, max_disp, hw, align_corners=False):
    """``(disp, uncertainty at disp)`` of a head's logits."""
    prob = head_probs(cost, max_disp, hw, align_corners)
    disp = soft_argmin(prob)
    return disp, spread_at(prob, disp)


def embed(time_head, latent, t, scale):
    """The time-embedded latent clamped to ±scale and mapped to [0, 1]."""
    return (time_head(latent, t).clamp(-scale, scale) / scale + 1.0) / 2.0


# ---------------------------------------------------------------- ACVNet


class HourglassACV(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = nn.Sequential(convbn3d(ch, 2 * ch, 3, 2, 1), nn.ReLU())
        self.conv2 = nn.Sequential(convbn3d(2 * ch, 2 * ch, 3, 1, 1), nn.ReLU())
        self.conv3 = nn.Sequential(convbn3d(2 * ch, 4 * ch, 3, 2, 1), nn.ReLU())
        self.conv4 = nn.Sequential(convbn3d(4 * ch, 4 * ch, 3, 1, 1), nn.ReLU())
        self.attention_block = WindowAttention3D(4 * ch)
        self.conv5 = DeconvBN(4 * ch, 2 * ch)
        self.conv6 = DeconvBN(2 * ch, ch)
        self.redir1 = convbn3d(ch, ch, 1, 1, 0)
        self.redir2 = convbn3d(2 * ch, 2 * ch, 1, 1, 0)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c4 = self.attention_block(self.conv4(self.conv3(c2)))
        c5 = F.relu(self.conv5(c4) + self.redir2(c2))
        return F.relu(self.conv6(c5) + self.redir1(x))


class ACVTrunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(ConvBN(3, 32, 3, 2, 1), nn.ReLU(), ConvBN(32, 32, 3, 1, 1),
                                       nn.ReLU(), ConvBN(32, 32, 3, 1, 1), nn.ReLU())
        self.layer1 = make_layer(32, 32, 3, 1, 1, "relu")
        self.layer2 = make_layer(32, 64, 16, 2, 1, "relu")
        self.layer3 = make_layer(64, 128, 3, 1, 1, "relu")
        self.layer4 = make_layer(128, 128, 3, 1, 2, "relu")

    def forward(self, x):
        l2 = self.layer2(self.layer1(self.firstconv(x)))
        l3 = self.layer3(l2)
        return torch.cat([l2, l3, self.layer4(l3)], 1)


def _classif(a="relu"):
    return nn.Sequential(convbn3d(32, 32, 3, 1, 1), act(a), head3d())


class ACVNet(nn.Module):
    """ACVNet (attention-filtered concat volume) and, with ``diffusion``,
    ACVNet-DDIM's time embedding."""

    def __init__(self, max_disp=192, diffusion=True, scale=1.0, groups=40, concat=32):
        super().__init__()
        self.max_disp, self.diffusion, self.scale, self.groups = max_disp, diffusion, scale, groups
        self.feature_extraction = ACVTrunk()
        self.concatconv = nn.Sequential(ConvBN(320, 128, 3, 1, 1), nn.ReLU(),
                                        nn.Conv2d(128, concat, 1, bias=False))

        def patch(ch, dil):
            return nn.Conv3d(ch, ch, (1, 3, 3), 1, (0, dil, dil), (1, dil, dil), ch, bias=False)

        self.patch = patch(groups, 1)
        self.patch_l1, self.patch_l2, self.patch_l3 = patch(8, 1), patch(16, 2), patch(16, 3)
        self.dres1_att_ = nn.Sequential(convbn3d(groups, 32, 3, 1, 1), nn.ReLU(),
                                        convbn3d(32, 32, 3, 1, 1))
        self.dres2_att_ = HourglassACV(32)
        self.classif_att_ = _classif()
        if diffusion:
            self.time_embedding = TimeHead(max_disp // 4)
        self.dres0 = nn.Sequential(convbn3d(2 * concat, 32, 3, 1, 1), nn.ReLU(),
                                   convbn3d(32, 32, 3, 1, 1), nn.ReLU())
        self.dres1 = nn.Sequential(convbn3d(32, 32, 3, 1, 1), nn.ReLU(),
                                   convbn3d(32, 32, 3, 1, 1))
        self.dres2 = HourglassACV(32)
        self.dres3 = HourglassACV(32)
        self.classif0, self.classif1, self.classif2 = _classif(), _classif(), _classif()

    def attention(self, left, right):
        """``(concat features l, r, attention logits (B, D, H4, W4))``."""
        fl = self.feature_extraction(left.permute(0, 3, 1, 2))
        fr = self.feature_extraction(right.permute(0, 3, 1, 2))
        g = self.patch(gwc_volume(fl, fr, self.max_disp // 4, self.groups))
        g = torch.cat([self.patch_l1(g[:, :8]), self.patch_l2(g[:, 8:24]),
                       self.patch_l3(g[:, 24:40])], 1)
        att = self.classif_att_(self.dres2_att_(self.dres1_att_(g)))[:, 0]
        return self.concatconv(fl), self.concatconv(fr), att

    def entry(self, left, right):
        """The DDIM model's per-pair inputs: the plain concat volume and the
        attention softmaxed over disparity."""
        cl, cr, att = self.attention(left, right)
        return concat_volume(cl, cr, self.max_disp // 4), torch.softmax(att, 1)

    def aggregate(self, vol):
        """``(cost0, out1, out2)``: the stages the three heads read."""
        c0 = self.dres0(vol)
        c0 = self.dres1(c0) + c0
        out1 = self.dres2(c0)
        return c0, out1, self.dres3(out1)

    def forward(self, left, right):
        """Eval: ``(disp, uncertainty)`` at full resolution."""
        vol, att = self.entry(left, right)
        out2 = self.aggregate(vol * att[:, None])[2]
        return regress(self.classif2(out2)[:, 0], self.max_disp, left.shape[1:3])

    def denoise(self, entry, latent, t, hw):
        """One DDIM step's pass: ``(disp, unc, the [0, 1] transformed latent)``."""
        vol, att = entry
        noise = embed(self.time_embedding, latent, t, self.scale)
        out2 = self.aggregate(vol * (att * noise)[:, None])[2]
        disp, unc = regress(self.classif2(out2)[:, 0], self.max_disp, hw)
        return disp, unc, noise

    def train_forward(self, left, right, noisy, t):
        """The four training heads ``[att, pred0, pred1, pred2]`` (SceneFlow
        ``acv_ddim.py``): the attention-filtered concat volume multiplied by
        the embedded ``noisy`` latent."""
        cl, cr, att = self.attention(left, right)
        vol = concat_volume(cl, cr, self.max_disp // 4) * torch.softmax(att, 1)[:, None]
        vol = vol * embed(self.time_embedding, noisy, t, self.scale)[:, None]
        c0, out1, out2 = self.aggregate(vol)
        heads = [att, self.classif0(c0)[:, 0], self.classif1(out1)[:, 0],
                 self.classif2(out2)[:, 0]]
        return [soft_argmin(head_probs(h, self.max_disp, left.shape[1:3])) for h in heads]


# ---------------------------------------------------------------- PCWNet


def _head2d(cin, mid, cout, a):
    return nn.Sequential(ConvBN(cin, mid, 3, 1, 1), act(a), nn.Conv2d(mid, cout, 1, bias=False))


def _cbr3d(cin, cout, stride, a):
    return nn.Sequential(convbn3d(cin, cout, 3, stride, 1), act(a))


class PCWTrunk(nn.Module):
    """The feature pyramid to 1/32: gw features (320 channels at 1/4 ..
    1/32), concat features (``cc`` channels each, none when 0) and the
    32-channel refinement feature at 1/4."""

    def __init__(self, cc, a):
        super().__init__()
        self.cc = cc
        self.firstconv = nn.Sequential(ConvBN(3, 32, 3, 2, 1), act(a), ConvBN(32, 32, 3, 1, 1),
                                       act(a), ConvBN(32, 32, 3, 1, 1), act(a))
        self.layer1 = make_layer(32, 32, 3, 1, 1, a)
        self.layer2 = make_layer(32, 64, 16, 2, 1, a)
        self.layer3 = make_layer(64, 128, 3, 1, 1, a)
        self.layer4 = make_layer(128, 128, 3, 1, 2, a)
        self.layer5 = make_layer(128, 192, 3, 2, 1, a)
        self.layer7 = make_layer(192, 256, 3, 2, 1, a)
        self.layer9 = make_layer(256, 512, 3, 2, 1, a)
        self.layer11 = _head2d(320, 320, 320, a)
        self.gw2, self.gw3, self.gw4 = (_head2d(c, 320, 320, a) for c in (192, 256, 512))
        self.layer_refine = nn.Sequential(ConvBN(320, 128, 3, 1, 1), act(a),
                                          ConvBN(128, 32, 1, 1, 0), act(a))
        if cc:
            self.lastconv = _head2d(320, 128, cc, a)
            self.concat2, self.concat3, self.concat4 = (_head2d(c, 128, cc, a)
                                                        for c in (192, 256, 512))

    def forward(self, x):
        l2 = self.layer2(self.layer1(self.firstconv(x)))
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        l5 = self.layer5(l4)
        l6 = self.layer7(l5)
        l7 = self.layer9(l6)
        comb = torch.cat([l2, l3, l4], 1)
        out = {"gw1": self.layer11(comb), "gw2": self.gw2(l5), "gw3": self.gw3(l6),
               "gw4": self.gw4(l7), "refine": self.layer_refine(comb)}
        if self.cc:
            out.update(concat1=self.lastconv(comb), concat2=self.concat2(l5),
                       concat3=self.concat3(l6), concat4=self.concat4(l7))
        return out


class HourglassUp(nn.Module):
    """Strided 3-D convs to 1/32, each level combined with that scale's
    volume, transposed convs back with skips."""

    def __init__(self, ch, a, vol_ch):
        super().__init__()
        self.act = act(a)
        self.conv1 = nn.Conv3d(ch, 2 * ch, 3, 2, 1, bias=False)
        self.conv2 = _cbr3d(2 * ch, 2 * ch, 1, a)
        self.conv3 = nn.Conv3d(2 * ch, 4 * ch, 3, 2, 1, bias=False)
        self.conv4 = _cbr3d(4 * ch, 4 * ch, 1, a)
        self.conv5 = nn.Conv3d(4 * ch, 4 * ch, 3, 2, 1, bias=False)
        self.conv6 = _cbr3d(4 * ch, 4 * ch, 1, a)
        self.conv7 = DeconvBN(4 * ch, 4 * ch)
        self.conv8 = DeconvBN(4 * ch, 2 * ch)
        self.conv9 = DeconvBN(2 * ch, ch)
        self.combine1 = _cbr3d(2 * ch + vol_ch, 2 * ch, 1, a)
        self.combine2 = _cbr3d(4 * ch + vol_ch, 4 * ch, 1, a)
        self.combine3 = _cbr3d(4 * ch + vol_ch, 4 * ch, 1, a)
        self.redir1 = convbn3d(ch, ch, 1, 1, 0)
        self.redir2 = convbn3d(2 * ch, 2 * ch, 1, 1, 0)
        self.redir3 = convbn3d(4 * ch, 4 * ch, 1, 1, 0)

    def forward(self, x, v2, v3, v4):
        c1 = self.combine1(torch.cat([self.conv1(x), v2], 1))
        c2 = self.conv2(c1)
        c3 = self.combine2(torch.cat([self.conv3(c2), v3], 1))
        c4 = self.conv4(c3)
        c5 = self.combine3(torch.cat([self.conv5(c4), v4], 1))
        c6 = self.conv6(c5)
        c7 = self.act(self.conv7(c6) + self.redir3(c4))
        c8 = self.act(self.conv8(c7) + self.redir2(c2))
        return self.act(self.conv9(c8) + self.redir1(x))


class HourglassMish(nn.Module):
    def __init__(self, ch, a):
        super().__init__()
        self.act = act(a)
        self.conv1 = _cbr3d(ch, 2 * ch, 2, a)
        self.conv2 = _cbr3d(2 * ch, 2 * ch, 1, a)
        self.conv3 = _cbr3d(2 * ch, 4 * ch, 2, a)
        self.conv4 = _cbr3d(4 * ch, 4 * ch, 1, a)
        self.conv5 = DeconvBN(4 * ch, 2 * ch)
        self.conv6 = DeconvBN(2 * ch, ch)
        self.redir1 = convbn3d(ch, ch, 1, 1, 0)
        self.redir2 = convbn3d(2 * ch, 2 * ch, 1, 1, 0)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c4 = self.conv4(self.conv3(c2))
        c5 = self.act(self.conv5(c4) + self.redir2(c2))
        return self.act(self.conv6(c5) + self.redir1(x))


class RefineNet(nn.Module):
    """Full-resolution dilated refinement (146 channels in) → a residual."""

    def __init__(self, a, cin=146):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBN(cin, 128, 3, 1, 1), act(a))
        self.conv2 = nn.Sequential(ConvBN(128, 128, 3, 1, 1), act(a))
        self.conv3 = nn.Sequential(ConvBN(128, 128, 3, 1, 1, 2), act(a))
        self.conv4 = nn.Sequential(ConvBN(128, 128, 3, 1, 1, 4), act(a))
        self.conv5 = nn.Sequential(BasicBlock(128, 96, 1, 1, 8, True, a))
        self.conv6 = nn.Sequential(BasicBlock(96, 64, 1, 1, 16, True, a))
        self.conv7 = nn.Sequential(BasicBlock(64, 32, 1, 1, 1, True, a))
        self.conv8 = nn.Conv2d(32, 1, 3, 1, 1, bias=False)

    def forward(self, x, disp):
        for i in range(1, 9):
            x = getattr(self, f"conv{i}")(x)
        return disp + x[:, 0]


class PCWNet(nn.Module):
    """PCWNet (KITTI12 ``pwcnet_ddim.py``): group-wise (and with
    ``concat``, concat) volumes at four scales fused by ``HourglassUp``,
    three hourglasses, the head at ``align_corners=True`` and the
    warp-correlation refinement; with ``diffusion`` the time embedding."""

    REFINE_OFFSET = 24

    def __init__(self, max_disp=192, diffusion=True, scale=1.0, groups=40, concat=True,
                 a="mish"):
        super().__init__()
        self.max_disp, self.diffusion, self.scale, self.groups = max_disp, diffusion, scale, groups
        self.cc = 12 if concat else 0
        vol_ch = groups + 2 * self.cc
        self.feature_extraction = PCWTrunk(self.cc, a)
        self.dres0 = nn.Sequential(convbn3d(vol_ch, 32, 3, 1, 1), act(a),
                                   convbn3d(32, 32, 3, 1, 1), act(a))
        self.dres1 = nn.Sequential(convbn3d(32, 32, 3, 1, 1), act(a), convbn3d(32, 32, 3, 1, 1))
        self.combine1 = HourglassUp(32, a, vol_ch)
        if diffusion:
            self.time_embedding = TimeHead(max_disp // 4)
        self.dres2, self.dres3, self.dres4 = (HourglassMish(32, a) for _ in range(3))
        for k in range(5):
            setattr(self, f"classif{k}", _classif(a))
        self.refinenet3 = RefineNet(a)
        self.dispupsample = nn.Sequential(ConvBN(1, 32, 1, 1, 0), act(a))

    def volumes(self, fl, fr):
        out = []
        for i in (1, 2, 3, 4):
            d = self.max_disp // (4 << (i - 1))
            v = gwc_volume(fl[f"gw{i}"], fr[f"gw{i}"], d, self.groups)
            if self.cc:
                v = torch.cat([v, concat_volume(fl[f"concat{i}"], fr[f"concat{i}"], d, True)], 1)
            out.append(v)
        return out

    def combine(self, fl, fr):
        """``(cost0, the fused volume)``."""
        v1, v2, v3, v4 = self.volumes(fl, fr)
        c0 = self.dres0(v1)
        c0 = self.dres1(c0) + c0
        return c0, self.combine1(c0, v2, v3, v4)

    def refine(self, pred3, fl, fr, hw):
        rl = F.interpolate(fl["refine"], hw, mode="bilinear", align_corners=True)
        rr = warp_to_left(F.interpolate(fr["refine"], hw, mode="bilinear", align_corners=True),
                          pred3)
        corr = signed_correlation(rl, rr, self.REFINE_OFFSET)
        p = pred3[:, None]
        x = torch.cat([rl - rr, rl, self.dispupsample(p), p, corr], 1)
        return self.refinenet3(x, pred3)

    def features(self, left, right):
        return (self.feature_extraction(left.permute(0, 3, 1, 2)),
                self.feature_extraction(right.permute(0, 3, 1, 2)))

    def entry(self, left, right):
        fl, fr = self.features(left, right)
        return self.combine(fl, fr)[1], fl, fr

    def head(self, vol, fl, fr, hw):
        """``(refined disp, its uncertainty)`` of the last hourglass's head."""
        out = self.dres4(self.dres3(self.dres2(vol)))
        prob = head_probs(self.classif3(out)[:, 0], self.max_disp, hw, True)
        disp = self.refine(soft_argmin(prob), fl, fr, hw)
        return disp, spread_at(prob, disp)

    def forward(self, left, right):
        vol, fl, fr = self.entry(left, right)
        return self.head(vol, fl, fr, left.shape[1:3])

    def denoise(self, entry, latent, t, hw):
        vol, fl, fr = entry
        noise = embed(self.time_embedding, latent, t, self.scale)
        disp, unc = self.head(vol * noise[:, None], fl, fr, hw)
        return disp, unc, noise
