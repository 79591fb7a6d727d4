"""IGEV-Stereo's multi-level ConvGRU update block, eval only.

Counterpart of ``diffuvolume_tpu/models/igev/update.py`` (the reference's
``core/update.py:6-142``), with the reference's module names.  The JAX
package's TPU layout devices (the per-piece convs over a concatenation, the
1-output-lane head as tap matmuls, the 7×7 one-channel conv unfolded) are
the same functions written as plain 2-D convs here.  NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.regression import resize_bilinear


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3×3 average pool, stride 2, padding 1, the padding counted."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def interp_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to ``ref``'s spatial size, align_corners=True."""
    return resize_bilinear(x, ref.shape[-2:], 2, 3, align_corners=True)


class ConvGRU(nn.Module):
    """Gated conv recurrence with context biases (``update.py:26-42``)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz = nn.Conv2d(c, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(c, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(c, hidden_dim, 3, padding=1)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class DispHead(nn.Module):
    """Δdisparity head (``update.py:16-24``): 3×3 conv, ReLU, 3×3 conv to 1."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, output_dim, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class BasicMotionEncoder(nn.Module):
    """Lookup features and disparity → 128-channel motion feature
    (``update.py:75-93``); the disparity rides along as the last channel."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convd1 = nn.Conv2d(1, 64, 7, padding=3)
        self.convd2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 127, 3, padding=1)

    def forward(self, disp, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        dsp = torch.relu(self.convd2(torch.relu(self.convd1(disp))))
        out = torch.relu(self.conv(torch.cat([cor, dsp], dim=1)))
        return torch.cat([out, disp], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """The three-level GRU cascade with cross-scale pooling and
    interpolation (``update.py:106-142``).  ``net`` holds the hidden states
    ``[1/4, 1/8, 1/16]``, ``inp`` the context biases ``(cz, cr, cq)`` per
    level."""

    def __init__(self, hidden_dims=(128, 128, 128), n_gru_layers: int = 3, corr_levels: int = 2,
                 corr_radius: int = 4):
        super().__init__()
        self.n_gru_layers = n_gru_layers
        self.encoder = BasicMotionEncoder(corr_levels * (2 * corr_radius + 1) * 9)
        enc_dim = 128
        self.gru04 = ConvGRU(hidden_dims[2], enc_dim + hidden_dims[1] * (n_gru_layers > 1))
        self.gru08 = ConvGRU(hidden_dims[1],
                             hidden_dims[0] * (n_gru_layers == 3) + hidden_dims[2])
        self.gru16 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.disp_head = DispHead(hidden_dims[2], hidden_dim=256, output_dim=1)
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(hidden_dims[2], 32, 3, padding=1),
                                         nn.ReLU(inplace=True))

    def forward(self, net, inp, corr, disp):
        """One update of all levels: ``(net, mask_feat_4, delta_disp)``."""
        net = list(net)
        if self.n_gru_layers == 3:
            net[2] = self.gru16(net[2], *inp[2], pool2x(net[1]))
            net[1] = self.gru08(net[1], *inp[1], pool2x(net[0]), interp_to(net[2], net[1]))
        elif self.n_gru_layers == 2:
            net[1] = self.gru08(net[1], *inp[1], pool2x(net[0]))
        motion = self.encoder(disp, corr)
        if self.n_gru_layers > 1:
            net[0] = self.gru04(net[0], *inp[0], motion, interp_to(net[1], net[0]))
        else:
            net[0] = self.gru04(net[0], *inp[0], motion)
        return net, self.mask_feat_4(net[0]), self.disp_head(net[0])
