"""IGEV-Stereo's feature extractors and basic blocks.

Counterpart of ``diffuvolume_tpu/models/igev/extractor.py``: the norms and
conv blocks of the reference's ``submodule.py`` (``BasicConv``,
``BasicConv_IN``, ``Conv2x``, ``Conv2x_IN``), the MobileNetV2 trunk with its
FPN fusion (``Feature``, timm's ``mobilenetv2_100`` blocks under timm's
names) and the RAFT context encoder (``MultiBasicEncoder``).  Module names
follow the reference state dict (KITTI15 ``core/extractor.py``,
``core/submodule.py``; the keys ``tools/weights.py:igev_rules`` lists), so a
checkpoint loads by name.  Tensors are NCHW / NCDHW; the 3-D volumes are kept
in ``torch.channels_last_3d`` memory format (NDHWC in memory), so that the
3×3×3 convs at 8 or 16 input channels run on the port's kernel
(``conv3d_fold_small``) without a copy, and cuDNN and BatchNorm take the rest
as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffuvolume_tpu_torch.models.layers import (
    BatchNorm2d,
    BatchNorm3d,
    conv3d_rows,
    conv_transpose3d_rows,
)
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import LEAKY_SLOPE, conv3d_fold_small
from diffuvolume_tpu_torch.ops.regression import at_least_f32
from diffuvolume_tpu_torch.parallel.volume_sharding import current_volume_spec, halo

# The mobilenetv2_100 stages of the reference's Feature split
# (extractor.py:332-341): (expansion, channels, repeats, first stride), and
# the block that ends each of block0 … block4 (block3 holds two stages).
MBV2_STAGES = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2), (6, 96, 3, 1),
    (6, 160, 3, 2),
]
MBV2_BLOCKS = [[0], [1], [2], [3, 4], [5]]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """A 5-D tensor in ``channels_last_3d`` memory format (a no-op if it is)."""
    return x.contiguous(memory_format=torch.channels_last_3d)


def conv3x3x3_small(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A 3×3×3 stride-1 pad-1 conv without bias at 8 or 16 input channels on
    the port's kernel: ``x (B, C, D, H, W)`` (channels-last memory), weight
    ``(Co, C, 3, 3, 3)`` → ``(B, Co, D, H, W)`` in channels-last memory."""
    y = conv3d_fold_small(x.permute(0, 2, 3, 4, 1).contiguous(),
                          weight.permute(2, 3, 4, 1, 0).contiguous())
    return y.permute(0, 4, 1, 2, 3)


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d``'s default (no affine, no running statistics),
    taken in float32 and returned in the input's dtype."""

    def forward(self, x):
        return F.instance_norm(at_least_f32(x), eps=1e-5).to(x.dtype)


def _conv(dims: int, deconv: bool):
    if deconv:
        return nn.ConvTranspose3d if dims == 3 else nn.ConvTranspose2d
    return nn.Conv3d if dims == 3 else nn.Conv2d


class BasicConv(nn.Module):
    """Conv (or transposed conv) without bias, BatchNorm, LeakyReLU 0.01
    (``submodule.py:9-37``).  ``bn=False`` registers no BatchNorm (the
    reference registers an unused one on ``cost_agg.conv1_up``).  In eval
    mode a 3-D 3×3×3 stride-1 conv at 8 or 16 input channels runs on
    ``conv3d_fold_small``, as the JAX package's TPU dispatch runs it; in
    training mode PyTorch's conv (the kernel has no backward), as the JAX
    dispatch keeps XLA's in training.  Under ``parallel/volume_sharding.py``
    a 3-D one works on this rank's band of rows: the conv takes its halo
    (``models/layers.py``), the kernel's fixed padding one row a side and
    a crop."""

    def __init__(self, in_ch, out_ch, deconv=False, is_3d=False, bn=True, relu=True,
                 kernel_size=3, stride=1, padding=1):
        super().__init__()
        self.relu = relu
        self.conv = _conv(3 if is_3d else 2, deconv)(in_ch, out_ch, kernel_size, stride=stride,
                                                      padding=padding, bias=False)
        self.bn = (BatchNorm3d if is_3d else BatchNorm2d)(out_ch) if bn else None
        self.small = (is_3d and not deconv and kernel_size == 3 and stride == 1
                      and padding == 1 and in_ch <= 16)

    def forward(self, x):
        if x.dim() == 5 and current_volume_spec() is not None:
            x = self._conv_rows(x)
        else:
            x = (conv3x3x3_small(x, self.conv.weight) if self.small and not self.training
                 else self.conv(x))
        if self.bn is not None:
            x = self.bn(x)
        return leaky_relu(x) if self.relu else x


    def _conv_rows(self, x):
        if isinstance(self.conv, nn.ConvTranspose3d):
            return conv_transpose3d_rows(self.conv, x)
        if self.small and not self.training:
            return conv3x3x3_small(halo(x, 1, 1), self.conv.weight).narrow(3, 1, x.shape[3])
        return conv3d_rows(self.conv, x)


class BasicConvIN(nn.Module):
    """Conv (or transposed conv) without bias, InstanceNorm, LeakyReLU 0.01
    (``BasicConv_IN``, ``submodule.py:84-106``); 2-D."""

    def __init__(self, in_ch, out_ch, deconv=False, kernel_size=3, stride=1, padding=1):
        super().__init__()
        self.conv = _conv(2, deconv)(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                                     bias=False)
        self.IN = InstanceNorm()

    def forward(self, x):
        return leaky_relu(self.IN(self.conv(x)))


class Conv2x(nn.Module):
    """Up- (k4 transposed) or down-sample, then fuse with ``rem`` by concat
    and a 3×3 conv (``Conv2x`` / ``Conv2x_IN``, ``submodule.py:41-148``);
    ``norm`` "batch" or "instance"; 2-D."""

    def __init__(self, in_ch, out_ch, deconv=False, norm: str = "batch"):
        super().__init__()
        k = 4 if deconv else 3
        if norm == "batch":
            self.conv1 = BasicConv(in_ch, out_ch, deconv, kernel_size=k, stride=2, padding=1)
            self.conv2 = BasicConv(2 * out_ch, 2 * out_ch, kernel_size=3, stride=1, padding=1)
        else:
            self.conv1 = BasicConvIN(in_ch, out_ch, deconv, kernel_size=k, stride=2, padding=1)
            self.conv2 = BasicConvIN(2 * out_ch, 2 * out_ch, kernel_size=3, stride=1, padding=1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[-2:] != rem.shape[-2:]:
            x = F.interpolate(x, size=rem.shape[-2:], mode="nearest")
        return self.conv2(torch.cat([x, rem], dim=1))


class DepthwiseSeparable(nn.Module):
    """timm's ``DepthwiseSeparableConv`` (the expansion-1 block): depthwise
    3×3, BatchNorm, ReLU6, pointwise, BatchNorm; a skip when the shape
    allows it."""

    def __init__(self, in_ch, out_ch, stride):
        super().__init__()
        self.conv_dw = nn.Conv2d(in_ch, in_ch, 3, stride, 1, groups=in_ch, bias=False)
        self.bn1 = BatchNorm2d(in_ch)
        self.conv_pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = BatchNorm2d(out_ch)
        self.skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = self.bn2(self.conv_pw(F.relu6(self.bn1(self.conv_dw(x)))))
        return y + x if self.skip else y


class InvertedResidual(nn.Module):
    """timm's ``InvertedResidual``: pointwise expansion, BatchNorm, ReLU6,
    depthwise 3×3, BatchNorm, ReLU6, pointwise projection, BatchNorm; a skip
    when the shape allows it."""

    def __init__(self, in_ch, out_ch, stride, expand):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.conv_dw = nn.Conv2d(mid, mid, 3, stride, 1, groups=mid, bias=False)
        self.bn2 = BatchNorm2d(mid)
        self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.skip = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = F.relu6(self.bn1(self.conv_pw(x)))
        y = F.relu6(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.skip else y


class Feature(nn.Module):
    """MobileNetV2 trunk (width 1.0, ReLU6) and the ``Conv2x_IN`` FPN fusion
    (``extractor.py:327-361``): ``(B, 3, H, W)`` →
    ``[x4 (48 @1/4), x8 (64 @1/8), x16 (192 @1/16), x32 (160 @1/32)]``."""

    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(32)
        c = 32
        blocks = []
        for stages in MBV2_BLOCKS:
            seqs = []
            for si in stages:
                t, out, n, s = MBV2_STAGES[si]
                layers = []
                for bi in range(n):
                    stride = s if bi == 0 else 1
                    layers.append(DepthwiseSeparable(c, out, stride) if t == 1
                                  else InvertedResidual(c, out, stride, t))
                    c = out
                seqs.append(nn.Sequential(*layers))
            blocks.append(nn.Sequential(*seqs))
        self.block0, self.block1, self.block2, self.block3, self.block4 = blocks
        self.deconv32_16 = Conv2x(160, 96, deconv=True, norm="instance")
        self.deconv16_8 = Conv2x(192, 32, deconv=True, norm="instance")
        self.deconv8_4 = Conv2x(64, 24, deconv=True, norm="instance")
        self.conv4 = BasicConvIN(48, 48, kernel_size=3, stride=1, padding=1)

    def forward(self, x):
        x = F.relu6(self.bn1(self.conv_stem(x)))
        x2 = self.block0(x)
        x4 = self.block1(x2)
        x8 = self.block2(x4)
        x16 = self.block3(x8)
        x32 = self.block4(x16)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


class ResidualBlock(nn.Module):
    """RAFT's residual block with BatchNorm (``extractor.py:10-65``).  As in
    the reference, ``norm3`` is registered and also sits inside
    ``downsample``, so the state dict holds it under both names."""

    def __init__(self, in_ch, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = BatchNorm2d(planes)
        self.norm2 = BatchNorm2d(planes)
        if stride == 1 and in_ch == planes:
            self.downsample = None
        else:
            self.norm3 = BatchNorm2d(planes)
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride), self.norm3)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class MultiBasicEncoder(nn.Module):
    """The context encoder (``extractor.py:200-304``, downsample 2): a 7×7
    stem and five residual layers to 1/16, then per GRU level and per
    output (hidden, context) a head: ``[(h04, c04), (h08, c08), (h16,
    c16)]``."""

    def __init__(self, output_dim=((128, 128, 128), (128, 128, 128))):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 1, 3)
        self.norm1 = BatchNorm2d(64)
        chans = [(64, 64, 1), (64, 96, 2), (96, 128, 2), (128, 128, 2), (128, 128, 2)]
        for i, (cin, c, s) in enumerate(chans):
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(ResidualBlock(cin, c, s), ResidualBlock(c, c, 1)))
        self.outputs04 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128), nn.Conv2d(128, dim[2], 3, padding=1))
            for dim in output_dim)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128), nn.Conv2d(128, dim[1], 3, padding=1))
            for dim in output_dim)
        self.outputs16 = nn.ModuleList(nn.Conv2d(128, dim[0], 3, padding=1)
                                       for dim in output_dim)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x04 = x
        x08 = self.layer4(x04)
        x16 = self.layer5(x08)
        return [[f(x04) for f in self.outputs04], [f(x08) for f in self.outputs08],
                [f(x16) for f in self.outputs16]]
