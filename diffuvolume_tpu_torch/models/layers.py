"""Building blocks of ACVNet and PCWNet in the reference's layout and module
names.

Counterpart of the ACV and PCW subset of ``diffuvolume_tpu/models/layers.py``,
and of its two factorised 3-D convs no path calls (``SeparableConvBN3d``,
``DepthwiseConvBN3d``).
The modules are built from ``nn.Sequential`` containers with the reference's
indices (``convbn`` = ``Sequential(conv, bn)``, activations as their own
entries), so a reference state dict loads by name.  ``ACTS`` names the
activation modules (``"relu"`` for ACVNet, ``"mish"`` for PCWNet).  Tensors
are NCHW / NCDHW inside the network.  ``BatchNorm2d`` / ``BatchNorm3d`` keep
PyTorch's state-dict names and update their running statistics in training
as ``flax.linen.BatchNorm`` does (the biased batch variance).

Under ``parallel/volume_sharding.py`` the 3-D layers of ACVNet, PCWNet and
IGEV's GEV tower work on this rank's band of rows (H, dim 3 of NCDHW): each
conv takes the halo its kernel reads across the band's edges
(``conv3d_rows``: 3×3×3 stride 1 one row a side; stride 2 one above; the
``(1, 3, 3)`` patch convs their dilation a side; 1×1×1 none) and runs with
no padding over H; a transposed conv takes the rows its taps reach and
crops (``conv_transpose3d_rows``: k3 s2 p1 op1 one row below, IGEV's k4 s2
p1 one a side); a kernel with a fixed padding (``PackedConv3d``, IGEV's
``conv3x3x3_small``) runs on the band with one row a side and drops the two
rows next to the halo; ``AttentionBlock3D``, whose windows cross bands,
gathers its input's rows, attends, and keeps this rank's.  BatchNorm,
ReLU, Mish, LeakyReLU and the other pointwise ops need no halo.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import conv3d_packed
from diffuvolume_tpu_torch.ops.regression import resize_linear
from diffuvolume_tpu_torch.parallel.volume_sharding import (
    band_of,
    current_volume_spec,
    gather_rows,
    halo,
)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x · tanh(softplus(x))."""
    return F.mish(x)


class Mish(nn.Module):
    """The reference's ``Mish`` module: x · tanh(softplus(x))."""

    def forward(self, x):
        return mish(x)


class _FlaxRunningStats:
    """Training-mode running statistics as ``flax.linen.BatchNorm(momentum
    0.9, epsilon 1e-5)`` keeps them: ``r ← 0.9·r + 0.1·s`` with the batch
    mean and the *biased* batch variance (PyTorch's own update takes the
    unbiased one, ``n/(n−1)`` larger).  Normalisation uses the batch
    statistics in training and the running ones in eval, as PyTorch's."""

    # Set by ``parallel/ddp.py:sync_batch_norm``: a sum over the
    # data-parallel ranks; the training statistics are then the global
    # batch's.
    reduce_stats = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.reduce_stats is not None:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        old = self.running_var.detach().clone()
        y = super().forward(x)
        # PyTorch set r = (1−m)·old + m·s·n/(n−1); the biased update is
        # ((n−1)·r + (1−m)·old) / n.  Written through ``.data``: the batch
        # norm's backward keeps the buffer (it reads it only in eval mode),
        # and PyTorch's own update does not count as a change of it either.
        with torch.no_grad():
            self.running_var.data.mul_(n - 1).add_(old, alpha=1.0 - self.momentum).div_(n)
        return y


    def _global_forward(self, x):
        """Training BatchNorm over the global batch (``_GlobalBatchNorm``);
        flax's running update from the global mean and biased variance."""
        weight = self.weight if self.affine else None
        bias = self.bias if self.affine else None
        y, mean, var = _GlobalBatchNorm.apply(x, weight, bias, self.eps, self.reduce_stats)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm's training forward and backward with every batch sum
    taken across the data-parallel ranks by ``reduce`` (a sum over the
    ranks, outside autograd), as ``nn.SyncBatchNorm`` takes them: the count
    and the channel sums, then the sums of squares around the global mean;
    in the backward the sums of ``dy`` and ``dy·x̂``, so that the input's
    gradient is the single-process formula over the global batch.  The
    affine parameters' gradients stay local (the ranks' gradients are
    summed after the backward).  Float32 (float64 stays).  Returns ``(y,
    mean, biased variance)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, reduce):
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // x.shape[1])])
        total = reduce(local)
        n = total[-1]
        mean = total[:-1] / n
        xc = xf - mean.view(shape)
        var = reduce((xc * xc).sum(dims)) / n
        invstd = torch.rsqrt(var + eps)
        xhat = xc * invstd.view(shape)
        y = xhat if weight is None else xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n, ctx.reduce, ctx.dtype = n, reduce, x.dtype
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, invstd, weight = ctx.saved_tensors
        dims = [0, *range(2, xhat.dim())]
        shape = [1, -1] + [1] * (xhat.dim() - 2)
        g = gy.to(xhat.dtype)
        sum_dy, sum_dy_xhat = g.sum(dims), (g * xhat).sum(dims)
        total = ctx.reduce(torch.cat([sum_dy, sum_dy_xhat]))
        c = sum_dy.shape[0]
        mean_dy, mean_dy_xhat = total[:c] / ctx.n, total[c:] / ctx.n
        scale = invstd if weight is None else invstd * weight
        gx = (g - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)) * scale.view(shape)
        gw = None if weight is None else sum_dy_xhat.to(weight.dtype)
        gb = None if weight is None else sum_dy.to(weight.dtype)
        return gx.to(ctx.dtype), gw, gb, None, None


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    pass


# Activation name → module factory, the counterpart of the JAX package's
# ``_ACTS`` for the activations the port's models use.
ACTS = {
    "relu": lambda: nn.ReLU(inplace=True),
    "mish": Mish,
    "leaky_relu": lambda: nn.LeakyReLU(0.01),
}


def _ntuple(x, n):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,) * n


def conv3d_rows(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; under ``volume_sharding``, a 3-D conv on this rank's
    band of rows: the band with the halo the kernel reads past its edges
    (``padding`` rows above, ``(k − 1)·dilation − padding − stride + 1``
    below, zeros at the global edges), convolved with no padding over H,
    gives the global output rows of the band (``stride`` must divide the
    band's first row).  ``PackedConv3d``'s kernel has a fixed padding: it
    runs on the band with one row a side and drops the two rows next to the
    halo, on the whole volume's K splits (``conv3d_packed``'s
    ``plan_shape``)."""
    if current_volume_spec() is None or not isinstance(conv, nn.Conv3d):
        return conv(x)
    k, s, p, d = (a[1] for a in (conv.kernel_size, conv.stride, conv.padding, conv.dilation))
    xh = halo(x, p, (k - 1) * d - p - s + 1)
    if isinstance(conv, PackedConv3d):  # stride 1, pad 1
        return conv(xh, whole_rows=band_of(x)[2]).narrow(3, 1, x.shape[3])
    return F.conv3d(xh, conv.weight, conv.bias, conv.stride,
                    (conv.padding[0], 0, conv.padding[2]), conv.dilation, conv.groups)


def conv_transpose3d_rows(deconv: nn.ConvTranspose3d, x: torch.Tensor) -> torch.Tensor:
    """``deconv(x)``; under ``volume_sharding``, a transposed conv on this
    rank's band ``[h0, h1)``, whose output band is ``[s·h0, s·h1)``: output
    row ``o`` reads input rows ``(o + p − t)/s`` over the taps ``t``, so the
    band takes ``⌊(k − 1 − p)/s⌋`` rows above and ``⌊(p − 1)/s⌋ + 1`` below
    (zeros past the edges) and keeps ``s·n`` output rows after the first
    ``s·top``: the hourglasses' k3 s2 p1 op1 form takes one row below, IGEV's
    k4 s2 p1 one a side."""
    if current_volume_spec() is None:
        return deconv(x)
    k, s, p = deconv.kernel_size[1], deconv.stride[1], deconv.padding[1]
    top, bottom = (k - 1 - p) // s, (p - 1) // s + 1
    op = deconv.output_padding
    y = F.conv_transpose3d(halo(x, top, bottom), deconv.weight, deconv.bias, deconv.stride,
                           deconv.padding, (op[0], 0, op[2]), deconv.groups, deconv.dilation)
    return y.narrow(3, s * top, s * x.shape[3])


class ConvBN(nn.Sequential):
    """Conv (2-D or 3-D) without bias, then BatchNorm: the reference's
    ``convbn`` / ``convbn_3d`` (children ``0`` conv, ``1`` bn).

    Padding follows the reference's rule, per axis: ``dilation`` where the
    dilation is above 1, else ``pad``.  ``kernel_size``, ``pad`` and
    ``dilation`` may be tuples, as for the ``(1, 3, 3)`` patch form.
    """

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, pad=0, dilation=1,
                 groups=1, dims=2):
        k = _ntuple(kernel_size, dims)
        dil = _ntuple(dilation, dims)
        padding = tuple(di if di > 1 else pi
                        for di, pi in zip(dil, _ntuple(pad, dims)))
        conv = (nn.Conv2d if dims == 2 else nn.Conv3d)(
            in_ch, out_ch, k, stride=stride, padding=padding, dilation=dil,
            groups=groups, bias=False,
        )
        bn = (BatchNorm2d if dims == 2 else BatchNorm3d)(out_ch)
        super().__init__(conv, bn)

    def forward(self, x):
        return self[1](conv3d_rows(self[0], x))


def convbn_3d(in_ch, out_ch, kernel_size, stride, pad) -> ConvBN:
    return ConvBN(in_ch, out_ch, kernel_size, stride, pad, dims=3)


class HeadConv3D(nn.Conv3d):
    """The ``(3,3,3) C→1`` classifier-head conv, no bias."""

    def __init__(self, in_ch: int = 32):
        super().__init__(in_ch, 1, 3, stride=1, padding=1, bias=False)

    def forward(self, x):
        if current_volume_spec() is None:
            return super().forward(x)
        return conv3d_rows(self, x)


class ConvTransposeBN(nn.Sequential):
    """``ConvTranspose3d`` (no bias) then BatchNorm3d, in the reference's
    orientation: weight ``(in, out, k, k, k)``.  The JAX package stores this
    kernel flipped in conv orientation; ``tools/weights.py`` undoes that."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=2, padding=1,
                 output_padding=1):
        super().__init__(
            nn.ConvTranspose3d(in_ch, out_ch, kernel_size, stride=stride,
                               padding=padding, output_padding=output_padding,
                               bias=False),
            BatchNorm3d(out_ch),
        )

    def forward(self, x):
        return self[1](conv_transpose3d_rows(self[0], x))


class SeparableConvBN3d(nn.Sequential):
    """The axis-factorised 3-D conv of the reference's ``convbn_3d_new`` /
    ``conv_3d_new`` (SceneFlow ``submodule.py:133-152``): ``(k,1,1)``, then
    ``(1,k,1)``, then ``(1,1,k)`` convs without bias, each carrying its
    axis's stride and padding, then BatchNorm (``use_bn``) and ``act``
    (an ``ACTS`` name).  Children ``0``–``2`` the convs, ``3`` the
    BatchNorm.  Counterpart of the JAX package's ``SeparableConvBN3d``; no
    path calls it."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1, use_bn=True,
                 act=None):
        k, st, p = kernel_size, stride, padding
        convs = [nn.Conv3d(in_ch if i == 0 else out_ch, out_ch,
                           tuple(k if a == i else 1 for a in range(3)),
                           stride=tuple(st if a == i else 1 for a in range(3)),
                           padding=tuple(p if a == i else 0 for a in range(3)), bias=False)
                 for i in range(3)]
        super().__init__(*convs, *([BatchNorm3d(out_ch)] if use_bn else []),
                         *([ACTS[act]()] if act else []))


class DepthwiseConvBN3d(nn.Sequential):
    """The reference's ``convbn_3d_dw`` / ``conv_3d_dw`` (SceneFlow
    ``submodule.py:154-163``): a depthwise ``k³`` conv without bias, a
    pointwise 1×1×1 conv with bias, BatchNorm (``use_bn``) and ``act``.
    Children ``0`` depthwise, ``1`` pointwise, ``2`` the BatchNorm.
    Counterpart of the JAX package's ``DepthwiseConvBN3d``; no path calls
    it."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1, use_bn=True,
                 act=None):
        super().__init__(
            nn.Conv3d(in_ch, in_ch, kernel_size, stride=stride, padding=padding, groups=in_ch,
                      bias=False),
            nn.Conv3d(in_ch, out_ch, 1),
            *([BatchNorm3d(out_ch)] if use_bn else []),
            *([ACTS[act]()] if act else []))


class BasicBlock(nn.Module):
    """2-D residual block (reference ``BasicBlock``, expansion 1), with the
    activation after conv1 named by ``act`` (ReLU for ACVNet, Mish for
    PCWNet's ``BasicBlockMish``)."""

    def __init__(self, in_ch, out_ch, stride=1, pad=1, dilation=1,
                 downsample=False, act: str = "relu"):
        super().__init__()
        self.conv1 = nn.Sequential(
            ConvBN(in_ch, out_ch, 3, stride, pad, dilation), ACTS[act]()
        )
        self.conv2 = ConvBN(out_ch, out_ch, 3, 1, pad, dilation)
        self.downsample = ConvBN(in_ch, out_ch, 1, stride, 0) if downsample else None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


class AttentionBlock3D(nn.Module):
    """Windowed multi-head self-attention over a ``(B, C, D, H, W)`` volume.

    ``(4,4,4)`` windows; H and W are zero-padded to window multiples, and a
    position may attend across the pad boundary only with a −1000 logit
    penalty; then a 1×1×1 conv (``final1x1``, applied as a matmul over
    channels).  Plain einsum and softmax.
    """

    def __init__(self, channels: int, num_heads: int = 16, block=(4, 4, 4)):
        super().__init__()
        self.num_heads = num_heads
        self.block = tuple(block)
        self.qkv_3d = nn.Linear(channels, 3 * channels, bias=True)
        self.final1x1 = nn.Conv3d(channels, channels, 1, bias=True)

    def forward(self, x):
        if current_volume_spec() is not None:
            # The windows cross bands: attend over every row (small at H/16),
            # keep this rank's.
            first, n, _ = band_of(x)
            return self._attend(gather_rows(x)).narrow(3, first, n)
        return self._attend(x)

    def _attend(self, x):
        b, c, d0, h0, w0 = x.shape
        b0, b1, b2 = self.block
        if d0 % b0:
            raise ValueError(f"depth {d0} is not a multiple of {b0}")
        pad_b = (b1 - h0 % b1) % b1
        pad_r = (b2 - w0 % b2) % b2
        x_p = F.pad(x, (0, pad_r, 0, pad_b)).permute(0, 2, 3, 4, 1)  # B,D,H,W,C
        _, d, h, w, _ = x_p.shape
        nd, nh, nw = d // b0, h // b1, w // b2
        n, blk, heads = nd * nh * nw, b0 * b1 * b2, self.num_heads

        win = x_p.reshape(b, nd, b0, nh, b1, nw, b2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        win = win.reshape(b, n, blk, c)
        qkv = self.qkv_3d(win).reshape(b, n, blk, 3, heads, c // heads)
        q, k, v = (qkv[..., i, :, :].permute(0, 1, 3, 2, 4) for i in range(3))
        attn = torch.einsum("bnhqd,bnhkd->bnhqk", q, k) * (c // heads) ** -0.5

        if pad_b > 0 or pad_r > 0:
            pad_flag = torch.zeros((h, w), dtype=attn.dtype, device=x.device)
            if pad_b > 0:
                pad_flag[-pad_b:, :] = 1.0
            if pad_r > 0:
                pad_flag[:, -pad_r:] = 1.0
            pf = pad_flag.reshape(nh, b1, nw, b2).permute(0, 2, 1, 3).reshape(
                nh * nw, b1 * b2)
            amask = pf[:, None, :] - pf[:, :, None]
            amask = torch.where(amask != 0, -1000.0, 0.0).to(attn.dtype)
            attn = attn + amask.repeat(nd, b0, b0)[None, :, None]

        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bnhqk,bnhkd->bnhqd", attn, v)
        out = out.permute(0, 1, 3, 2, 4).reshape(b, nd, nh, nw, b0, b1, b2, c)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)
        # final1x1 as a product over channels-last positions (a matmul, not a
        # 3-D conv), then back to NCDHW.
        out = F.linear(out[:, :, :h0, :w0], self.final1x1.weight.flatten(1),
                       self.final1x1.bias)
        return out.permute(0, 4, 1, 2, 3).contiguous()


class HourglassACV(nn.Module):
    """ACV 3-D hourglass with window attention at the bottleneck."""

    def __init__(self, ch: int):
        super().__init__()
        relu = lambda: nn.ReLU(inplace=True)  # noqa: E731
        self.conv1 = nn.Sequential(convbn_3d(ch, 2 * ch, 3, 2, 1), relu())
        self.conv2 = nn.Sequential(convbn_3d(2 * ch, 2 * ch, 3, 1, 1), relu())
        self.conv3 = nn.Sequential(convbn_3d(2 * ch, 4 * ch, 3, 2, 1), relu())
        self.conv4 = nn.Sequential(convbn_3d(4 * ch, 4 * ch, 3, 1, 1), relu())
        self.attention_block = AttentionBlock3D(4 * ch, num_heads=16, block=(4, 4, 4))
        self.conv5 = ConvTransposeBN(4 * ch, 2 * ch)
        self.conv6 = ConvTransposeBN(2 * ch, ch)
        self.redir1 = convbn_3d(ch, ch, 1, 1, 0)
        self.redir2 = convbn_3d(2 * ch, 2 * ch, 1, 1, 0)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c4 = self.attention_block(self.conv4(self.conv3(c2)))
        c5 = torch.relu(self.conv5(c4) + self.redir2(c2))
        return torch.relu(self.conv6(c5) + self.redir1(x))


class ACVFeatureExtractor(nn.Module):
    """ResNet-style trunk: ``(B, 3, H, W)`` → ``(B, 320, H/4, W/4)``, the
    concatenation of layer2 (64), layer3 (128) and layer4 (128)."""

    def __init__(self):
        super().__init__()
        relu = lambda: nn.ReLU(inplace=True)  # noqa: E731
        self.firstconv = nn.Sequential(
            ConvBN(3, 32, 3, 2, 1), relu(),
            ConvBN(32, 32, 3, 1, 1), relu(),
            ConvBN(32, 32, 3, 1, 1), relu(),
        )
        self.layer1 = self._make_layer(32, 32, 3, 1, 1)
        self.layer2 = self._make_layer(32, 64, 16, 2, 1)
        self.layer3 = self._make_layer(64, 128, 3, 1, 1)
        self.layer4 = self._make_layer(128, 128, 3, 1, 2)

    @staticmethod
    def _make_layer(in_ch, out_ch, blocks, stride, dilation):
        downsample = stride != 1 or in_ch != out_ch
        layers = [BasicBlock(in_ch, out_ch, stride, 1, dilation, downsample)]
        layers += [BasicBlock(out_ch, out_ch, 1, 1, dilation) for _ in range(blocks - 1)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        return torch.cat([l2, l3, l4], dim=1)


class SinusoidalTimeEmbed(nn.Module):
    """Sinusoidal timestep embedding, ``(B,)`` → ``(B, dim)`` float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freq = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * -(math.log(10000.0) / (half - 1))
        )
        ang = t.float()[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DynamicHead(nn.Module):
    """Time-embedding head: adds a per-bin shift to the noisy ``(B, D, H, W)``
    volume (reference ``head.py``; ``time_mlp`` / ``block_time_mlp``).  With
    ``out_bins`` (KITTI15's IGEV: ``d_model`` 180, 48 bins) the shift vector
    is resized linearly to ``out_bins`` (half-pixel centres)."""

    def __init__(self, d_model: int, out_bins: int | None = None):
        super().__init__()
        self.out_bins = out_bins
        self.time_mlp = nn.Sequential(
            SinusoidalTimeEmbed(d_model),
            nn.Linear(d_model, 4 * d_model),
            nn.GELU(),
            nn.Linear(4 * d_model, 4 * d_model),
        )
        self.block_time_mlp = nn.Sequential(nn.SiLU(), nn.Linear(4 * d_model, d_model))

    def forward(self, noisy, t):
        emb = self.time_mlp[0](t).to(self.time_mlp[1].weight.dtype)
        ss = self.block_time_mlp(self.time_mlp[1:](emb))
        if self.out_bins is not None and self.out_bins != ss.shape[1]:
            ss = resize_linear(ss, self.out_bins, 1)
        return noisy + ss[:, :, None, None]


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation scheme, drawn from ``generator``
    (CPU): convs and deconvs normal(0, sqrt(2/n)) with n = kernel volume ×
    output channels; Linear xavier-uniform; every bias 0; BatchNorm weight
    1, bias 0, running mean 0, running variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
                transposed = isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d))
                out_ch = m.weight.shape[1 if transposed else 0]
                n = math.prod(m.kernel_size) * out_ch
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / n))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator)
                               * (2 * bound) - bound)
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


# ``route_conv3d``'s input channels: the rest of ``conv3d_packed``'s range (8,
# 16) runs on ``conv3d_fold_small`` already where the models have it (IGEV).
ROUTED_CIN = (32, 64, 128)


class PackedConv3d(nn.Conv3d):
    """A 3×3×3 stride-1 pad-1 ``nn.Conv3d`` without dilation, groups or bias
    whose eval forward runs on ``conv3d_packed`` (TPU row 15), the
    counterpart of the JAX package's ``conv3x3x3`` under
    ``DIFFU_PALLAS_CONV3D=1``.  Made only by ``route_conv3d``, in place: the
    parameters and state-dict keys are the ``nn.Conv3d``'s.  A depth that is
    not a multiple of ``128 / C_in`` (the JAX rule) and training run the
    cuDNN conv, as the JAX dispatch keeps XLA's there.  The weight in the
    kernel's ``(3, 3, 3, C_in, C_out)`` order is made once and kept while the
    parameter is unchanged."""

    def _kernel_weight(self) -> torch.Tensor:
        key = (self.weight.data_ptr(), self.weight._version, self.weight.dtype)
        cached = getattr(self, "_packed_weight", None)
        if cached is None or cached[0] != key:
            cached = (key, self.weight.detach().permute(2, 3, 4, 1, 0).contiguous())
            self._packed_weight = cached
        return cached[1]

    def forward(self, x, whole_rows: int | None = None):
        """``whole_rows``: ``x`` is a band (with its halo) of a volume of that
        many rows, whose plan's K splits the kernel keeps."""
        if self.training or x.shape[2] % (128 // self.in_channels):
            return super().forward(x)
        # (B, C, D, H, W) → NDHWC: a view of a channels_last_3d volume, a
        # copy of an NCDHW one.
        args = (x.permute(0, 2, 3, 4, 1).contiguous(), self._kernel_weight())
        if whole_rows is None:
            return conv3d_packed(*args).permute(0, 4, 1, 2, 3)
        b, c, d, _, w = x.shape
        y = conv3d_packed(*args, plan_shape=(b, d, whole_rows, w, c))
        return y.permute(0, 4, 1, 2, 3)


def packed_eligible(conv: nn.Module) -> bool:
    """The JAX package's rule for ``conv3d_packed`` (``ConvBN``,
    ``layers.py:440-450``; IGEV's ``BasicConv``): a plain 3×3×3 stride-1
    pad-1 conv, undilated, ungrouped, no bias, C_in in ``ROUTED_CIN``.  The
    depth rule is the forward's."""
    return (type(conv) is nn.Conv3d and conv.kernel_size == (3, 3, 3)
            and conv.stride == (1, 1, 1) and conv.padding == (1, 1, 1)
            and conv.dilation == (1, 1, 1) and conv.groups == 1 and conv.bias is None
            and conv.in_channels in ROUTED_CIN)


def route_conv3d(model: nn.Module) -> nn.Module:
    """Run ``model``'s eligible 3-D convs on ``conv3d_packed``, in place: the
    conv child of each 3-D ``ConvBN`` and of each IGEV ``BasicConv`` that
    ``packed_eligible`` takes becomes a ``PackedConv3d``.  BatchNorm and
    the activation stay after it, unfused.  The classifier heads
    (``HeadConv3D``), the bare stride-2 convs and the transposed convs are
    not routed, as on the TPU.  The JAX package also sends its
    phase-decomposed transposed convs (``deconv3d_422_phases``) through this
    kernel; the port does not carry those over (its module path runs the
    transposed convs on cuDNN).  Pass the routed models with
    ``packed=False``; returns ``model``."""
    from diffuvolume_tpu_torch.models.igev.extractor import BasicConv

    for m in model.modules():
        if isinstance(m, ConvBN):
            conv = m[0]
        elif isinstance(m, BasicConv):
            conv = m.conv
        else:
            continue
        if packed_eligible(conv):
            conv.__class__ = PackedConv3d
    return model
