"""The SceneFlow training step of ACVNet-DDIM, plain PyTorch.

A rewrite of SceneFlow ``main.py``'s step: the ground truth clamped to
``[0, max_disp − 1]``, bilinear ↓4, ÷4 and encoded; the encoded volume
q-sampled at one timestep for the batch with the given noise; the
diffusion-conditioned forward; the smooth-L1 over the four heads with the
weights ``(0.5, 0.5, 0.7, 1.0)`` over pixels with ``0 < gt < max_disp``;
the backward; Adam.  The draws (``t``, ``noise``) are given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ddim import encode, q_sample, resize


def loss_of(net, batch, t, noise, weights):
    """The step's loss (a scalar tensor) for ``batch`` = ``(left, right, gt)``,
    and the last head's disparity."""
    left, right, gt = batch
    h, w = gt.shape[1:]
    md = net.max_disp
    gt_q = resize(gt.clamp(0, md - 1), (h // 4, w // 4)) / 4
    noisy = q_sample(encode(gt_q, md // 4, net.scale), t, noise)
    preds = net.train_forward(left, right, noisy, t)
    mask = ((gt > 0) & (gt < md)).float()
    count = mask.sum().clamp_min(1)
    loss = sum(wi * (F.smooth_l1_loss(p, gt, reduction="none") * mask).sum() / count
               for wi, p in zip(weights, preds))
    return loss, preds[-1]


def make_adam(net, lr):
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def step(net, opt, batch, t, noise, weights):
    """One step in training mode: ``(loss, last head's disparity)``, detached."""
    net.train()
    opt.zero_grad(set_to_none=False)
    loss, pred = loss_of(net, batch, t, noise, weights)
    loss.backward()
    opt.step()
    return loss.detach(), pred.detach()
