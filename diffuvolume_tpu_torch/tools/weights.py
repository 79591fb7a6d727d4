"""JAX-package variables → the port's ``state_dict``.

The inverse of the JAX package's ``convert_acv_state_dict``,
``convert_pcw_state_dict`` and ``convert_igev_state_dict``, with its own copy
of their rule tables
(reference state-dict key ↔ flax variable path).  Input is the JAX
package's variables as a nested dict of numpy arrays,
``{"params": ..., "batch_stats": ...}``; output is a dict of CPU tensors that
``ACVNet`` / ``PCWNet`` / ``IGEVStereo.load_state_dict`` takes.  The layout
changes are exact:

* conv kernel ``(kd, kh, kw, I, O)`` / ``(kh, kw, I, O)`` → ``(O, I, ...)``;
* deconv kernel, stored pre-flipped in conv orientation ``(k, k, k, I, O)``
  / ``(k, k, I, O)`` → un-flipped ``(I, O, k, k, k)`` / ``(I, O, k, k)``;
* Linear ``(I, O)`` → ``(O, I)``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var`` (plus ``num_batches_tracked`` = 0).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return k.transpose(3, 2, 0, 1)
    if k.ndim == 5:
        return k.transpose(4, 3, 0, 1, 2)
    raise ValueError(k.shape)


def _deconv(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return k.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]


def _linear(k: np.ndarray) -> np.ndarray:
    return k.T


Rule = tuple[str, str, str, Callable | None]  # torch key, collection, flax path, transform


def _bn(tp: str, fn: str) -> list[Rule]:
    return [
        (f"{tp}.weight", "params", f"{fn}/scale", None),
        (f"{tp}.bias", "params", f"{fn}/bias", None),
        (f"{tp}.running_mean", "batch_stats", f"{fn}/mean", None),
        (f"{tp}.running_var", "batch_stats", f"{fn}/var", None),
    ]


def _convbn(tp: str, fn: str) -> list[Rule]:
    return [(f"{tp}.0.weight", "params", f"{fn}/conv/kernel", _conv)] + _bn(
        f"{tp}.1", f"{fn}/bn")


def separable_convbn_3d_rules(tp: str, fn: str, use_bn: bool = True) -> list[Rule]:
    """``SeparableConvBN3d`` at ``tp`` ↔ the JAX module at ``fn``."""
    rules = [(f"{tp}.{i}.weight", "params", f"{fn}/conv{i}/kernel", _conv) for i in range(3)]
    return rules + (_bn(f"{tp}.3", f"{fn}/bn") if use_bn else [])


def depthwise_convbn_3d_rules(tp: str, fn: str, use_bn: bool = True) -> list[Rule]:
    """``DepthwiseConvBN3d`` at ``tp`` ↔ the JAX module at ``fn``."""
    rules = [(f"{tp}.0.weight", "params", f"{fn}/dw/kernel", _conv),
             (f"{tp}.1.weight", "params", f"{fn}/pw/kernel", _conv),
             (f"{tp}.1.bias", "params", f"{fn}/pw/bias", None)]
    return rules + (_bn(f"{tp}.2", f"{fn}/bn") if use_bn else [])


def _deconvbn(tp: str, fn: str) -> list[Rule]:
    return [(f"{tp}.0.weight", "params", f"{fn}/kernel", _deconv)] + _bn(f"{tp}.1", f"{fn}/bn")


def _hourglass(tp: str, fn: str, attention: bool = True) -> list[Rule]:
    """ACV's hourglass (window attention at the bottleneck) or PCW's Mish
    hourglass (``attention=False``)."""
    rules = []
    for i in (1, 2, 3, 4):
        rules += _convbn(f"{tp}.conv{i}.0", f"{fn}/conv{i}")
    if attention:
        ab, fab = f"{tp}.attention_block", f"{fn}/attention_block"
        rules += [
            (f"{ab}.qkv_3d.weight", "params", f"{fab}/qkv/kernel", _linear),
            (f"{ab}.qkv_3d.bias", "params", f"{fab}/qkv/bias", None),
            (f"{ab}.final1x1.weight", "params", f"{fab}/final1x1/kernel", _conv),
            (f"{ab}.final1x1.bias", "params", f"{fab}/final1x1/bias", None),
        ]
    for i in (5, 6):
        rules += _deconvbn(f"{tp}.conv{i}", f"{fn}/conv{i}")
    for r in (1, 2):
        rules += _convbn(f"{tp}.redir{r}", f"{fn}/redir{r}")
    return rules


def _basic_block(tp: str, fn: str, downsample: bool) -> list[Rule]:
    rules = _convbn(f"{tp}.conv1.0", f"{fn}/conv1") + _convbn(f"{tp}.conv2", f"{fn}/conv2")
    if downsample:
        rules += _convbn(f"{tp}.downsample", f"{fn}/downsample")
    return rules


def _time_embedding() -> list[Rule]:
    te, rules = "time_embedding", []
    for tk, fk in (("time_mlp.1", "time1"), ("time_mlp.3", "time2"),
                   ("block_time_mlp.1", "block")):
        rules += [
            (f"{te}.{tk}.weight", "params", f"{te}/{fk}/kernel", _linear),
            (f"{te}.{tk}.bias", "params", f"{te}/{fk}/bias", None),
        ]
    return rules


def _feature_extractor(tp: str, fn: str) -> list[Rule]:
    rules = []
    for i, seq in enumerate((0, 2, 4)):
        rules += _convbn(f"{tp}.firstconv.{seq}", f"{fn}/firstconv{i}")
    for layer, blocks, ds_first in (
        ("layer1", 3, False), ("layer2", 16, True), ("layer3", 3, True),
        ("layer4", 3, False),
    ):
        for i in range(blocks):
            rules += _basic_block(f"{tp}.{layer}.{i}", f"{fn}/{layer}_{i}",
                                  i == 0 and ds_first)
    return rules


def acv_rules(diffusion: bool = True) -> list[Rule]:
    """Every ACVNet(_DDIM) state-dict key with its flax variable path."""
    rules = _feature_extractor("feature_extraction", "feature_extraction")
    rules += _convbn("concatconv.0", "concatconv0")
    rules.append(("concatconv.2.weight", "params", "concatconv1/kernel", _conv))
    for p in ("patch", "patch_l1", "patch_l2", "patch_l3"):
        rules.append((f"{p}.weight", "params", f"{p}/conv/kernel", _conv))
    rules += _convbn("dres1_att_.0", "dres1_att_0")
    rules += _convbn("dres1_att_.2", "dres1_att_1")
    rules += _hourglass("dres2_att_", "dres2_att_")
    rules += _convbn("classif_att_.0", "classif_att_0")
    rules.append(("classif_att_.2.weight", "params", "classif_att_1/kernel", _conv))
    if diffusion:
        rules += _time_embedding()
    rules += _convbn("dres0.0", "dres0_0")
    rules += _convbn("dres0.2", "dres0_1")
    rules += _convbn("dres1.0", "dres1_0")
    rules += _convbn("dres1.2", "dres1_1")
    rules += _hourglass("dres2", "dres2")
    rules += _hourglass("dres3", "dres3")
    for k in (0, 1, 2):
        rules += _convbn(f"classif{k}.0", f"classif{k}_0")
        rules.append((f"classif{k}.2.weight", "params", f"classif{k}_1/kernel", _conv))
    return rules


def _head2d(tp: str, fn: str) -> list[Rule]:
    """``Sequential(convbn, act, Conv2d 1×1)`` → ``{fn}_0`` (ConvBN), ``{fn}_1``."""
    return _convbn(f"{tp}.0", f"{fn}_0") + [(f"{tp}.2.weight", "params", f"{fn}_1/kernel", _conv)]


def _hourglass_up(tp: str, fn: str) -> list[Rule]:
    rules = []
    for i in (1, 3, 5):  # bare strided Conv3d
        rules.append((f"{tp}.conv{i}.weight", "params", f"{fn}/conv{i}/kernel", _conv))
    for i in (2, 4, 6):
        rules += _convbn(f"{tp}.conv{i}.0", f"{fn}/conv{i}")
    for i in (7, 8, 9):
        rules += _deconvbn(f"{tp}.conv{i}", f"{fn}/conv{i}")
    for i in (1, 2, 3):
        rules += _convbn(f"{tp}.combine{i}.0", f"{fn}/combine{i}")
        rules += _convbn(f"{tp}.redir{i}", f"{fn}/redir{i}")
    return rules


def pcw_rules(diffusion: bool = True, use_concat_volume: bool = True) -> list[Rule]:
    """Every PCWNet (KITTI12 ``pwcnet_ddim.py``) state-dict key with its
    flax variable path; without ``use_concat_volume`` no concat heads
    (``lastconv``, ``concat2..4``), as upstream ``PWCNet_G`` has none (the
    JAX package's ``convert_torch_pcw.pcw_rules``)."""
    fe = "feature_extraction"
    rules = []
    for i, seq in enumerate((0, 2, 4)):
        rules += _convbn(f"{fe}.firstconv.{seq}", f"{fe}/firstconv{i}")
    for layer, blocks, ds_first in (
        ("layer1", 3, False), ("layer2", 16, True), ("layer3", 3, True),
        ("layer4", 3, False), ("layer5", 3, True), ("layer7", 3, True), ("layer9", 3, True),
    ):
        for i in range(blocks):
            rules += _basic_block(f"{fe}.{layer}.{i}", f"{fe}/{layer}_{i}", i == 0 and ds_first)
    heads = ("gw2", "gw3", "gw4", "layer11")
    if use_concat_volume:
        heads += ("lastconv", "concat2", "concat3", "concat4")
    for head in heads:
        rules += _head2d(f"{fe}.{head}", f"{fe}/{head}")
    rules += _convbn(f"{fe}.layer_refine.0", f"{fe}/layer_refine_0")
    rules += _convbn(f"{fe}.layer_refine.2", f"{fe}/layer_refine_1")
    rules += _convbn("dres0.0", "dres0_0")
    rules += _convbn("dres0.2", "dres0_1")
    rules += _convbn("dres1.0", "dres1_0")
    rules += _convbn("dres1.2", "dres1_1")
    rules += _hourglass_up("combine1", "combine1")
    if diffusion:
        rules += _time_embedding()
    for d in (2, 3, 4):
        rules += _hourglass(f"dres{d}", f"dres{d}", attention=False)
    for k in range(5):
        rules += _convbn(f"classif{k}.0", f"classif{k}_0")
        rules.append((f"classif{k}.2.weight", "params", f"classif{k}_1/kernel", _conv))
    rn = "refinenet3"
    for i in (1, 2, 3, 4):
        rules += _convbn(f"{rn}.conv{i}.0", f"{rn}/conv{i}")
    for i in (5, 6, 7):  # one BasicBlock each, Sequential index 0
        rules += _basic_block(f"{rn}.conv{i}.0", f"{rn}/conv{i}", True)
    rules.append((f"{rn}.conv8.weight", "params", f"{rn}/conv8/kernel", _conv))
    rules += _convbn("dispupsample.0", "dispupsample")
    return rules


def _conv_b(tp: str, fn: str, bias: bool = True) -> list[Rule]:
    """A conv (2-D or 3-D) and, with ``bias``, its bias."""
    rules = [(f"{tp}.weight", "params", f"{fn}/kernel", _conv)]
    if bias:
        rules.append((f"{tp}.bias", "params", f"{fn}/bias", None))
    return rules


def _basic_conv(tp: str, fn: str, deconv: bool = False, bn: bool = True) -> list[Rule]:
    """IGEV's ``BasicConv``: ``.conv`` (no bias) and ``.bn``."""
    rules = [(f"{tp}.conv.weight", "params", f"{fn}/conv/kernel", _deconv if deconv else _conv)]
    return rules + (_bn(f"{tp}.bn", f"{fn}/bn") if bn else [])


def _conv2x(tp: str, fn: str, norm: str) -> list[Rule]:
    """``Conv2x`` (BatchNorm) / ``Conv2x_IN``: the k4 transposed ``conv1``,
    the 3×3 ``conv2``; instance norm has no parameters."""
    bn = norm == "batch"
    return (_basic_conv(f"{tp}.conv1", f"{fn}/conv1", deconv=True, bn=bn)
            + _basic_conv(f"{tp}.conv2", f"{fn}/conv2", bn=bn))


def _feature_att(tp: str, fn: str) -> list[Rule]:
    return (_basic_conv(f"{tp}.feat_att.0", f"{fn}/att0")
            + _conv_b(f"{tp}.feat_att.1", f"{fn}/att1"))


def _residual_block(tp: str, fn: str, downsample: bool) -> list[Rule]:
    """RAFT's residual block; ``norm3`` also under its alias
    ``downsample.1``."""
    rules = (_conv_b(f"{tp}.conv1", f"{fn}/conv1") + _bn(f"{tp}.norm1", f"{fn}/norm1")
             + _conv_b(f"{tp}.conv2", f"{fn}/conv2") + _bn(f"{tp}.norm2", f"{fn}/norm2"))
    if downsample:
        rules += _conv_b(f"{tp}.downsample.0", f"{fn}/downsample")
        rules += _bn(f"{tp}.norm3", f"{fn}/norm3") + _bn(f"{tp}.downsample.1", f"{fn}/norm3")
    return rules


# The port's MobileNetV2 blocks: (torch prefix, has expansion), in the JAX
# package's block order block0 … block15.
_MBV2_BLOCKS = [("block0.0.0", False)] + [
    (f"block{blk}.{seq}.{i}", True)
    for blk, seq, n in ((1, 0, 2), (2, 0, 3), (3, 0, 4), (3, 1, 3), (4, 0, 3))
    for i in range(n)]


def _mbv2_block(tp: str, fn: str, expand: bool) -> list[Rule]:
    if not expand:
        return (_conv_b(f"{tp}.conv_dw", f"{fn}/dw", False) + _bn(f"{tp}.bn1", f"{fn}/dw_bn")
                + _conv_b(f"{tp}.conv_pw", f"{fn}/proj", False)
                + _bn(f"{tp}.bn2", f"{fn}/proj_bn"))
    return (_conv_b(f"{tp}.conv_pw", f"{fn}/pw", False) + _bn(f"{tp}.bn1", f"{fn}/pw_bn")
            + _conv_b(f"{tp}.conv_dw", f"{fn}/dw", False) + _bn(f"{tp}.bn2", f"{fn}/dw_bn")
            + _conv_b(f"{tp}.conv_pwl", f"{fn}/proj", False)
            + _bn(f"{tp}.bn3", f"{fn}/proj_bn"))


def igev_rules(diffusion: bool = True, n_gru_layers: int = 3) -> list[Rule]:
    """Every IGEVStereo(_ddim) state-dict key with its flax variable path
    (the JAX package's ``convert_torch_igev.igev_rules``)."""
    r = _conv_b("feature.conv_stem", "feature/conv_stem", False)
    r += _bn("feature.bn1", "feature/bn1")
    for idx, (tp, expand) in enumerate(_MBV2_BLOCKS):
        r += _mbv2_block(f"feature.{tp}", f"feature/block{idx}", expand)
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        r += _conv2x(f"feature.{name}", f"feature/{name}", "instance")
    r += _basic_conv("feature.conv4", "feature/conv4", bn=False)

    r += _conv_b("cnet.conv1", "cnet/conv1") + _bn("cnet.norm1", "cnet/norm1")
    for layer in range(1, 6):
        for blk in (0, 1):
            r += _residual_block(f"cnet.layer{layer}.{blk}", f"cnet/layer{layer}_{blk}",
                                 layer > 1 and blk == 0)
    for di in range(2):
        for lvl in ("04", "08"):
            r += _residual_block(f"cnet.outputs{lvl}.{di}.0", f"cnet/out{lvl}_{di}_res", False)
            r += _conv_b(f"cnet.outputs{lvl}.{di}.1", f"cnet/out{lvl}_{di}_conv")
        r += _conv_b(f"cnet.outputs16.{di}", f"cnet/out16_{di}")

    u = "update_block"
    for m in ("convc1", "convc2", "convd1", "convd2", "conv"):
        r += _conv_b(f"{u}.encoder.{m}", f"{u}/encoder/{m}")
    for gru in ("gru04", "gru08", "gru16"):
        for g in ("convz", "convr", "convq"):
            r += _conv_b(f"{u}.{gru}.{g}", f"{u}/{gru}/{g}")
    r += _conv_b(f"{u}.disp_head.conv1", f"{u}/disp_head/conv1")
    r += _conv_b(f"{u}.disp_head.conv2", f"{u}/disp_head/conv2")
    r += _conv_b(f"{u}.mask_feat_4.0", f"{u}/mask_feat_4")
    for i in range(n_gru_layers):
        r += _conv_b(f"context_zqr_convs.{i}", f"context_zqr_{i}")
    if diffusion:
        r += _time_embedding()

    for stem in ("stem_2", "stem_4", "spx_4"):
        r += _basic_conv(f"{stem}.0", f"{stem}_0", bn=False)
        r += _conv_b(f"{stem}.1", f"{stem}_1", False)
    r += _conv2x("spx_2", "spx_2", "instance")
    r += _conv2x("spx_2_gru", "spx_2_gru", "batch")
    for spx in ("spx", "spx_gru"):
        r += [(f"{spx}.0.weight", "params", f"{spx}/kernel", _deconv),
              (f"{spx}.0.bias", "params", f"{spx}/bias", None)]

    r += _basic_conv("conv", "conv", bn=False) + _conv_b("desc", "desc")
    r += _basic_conv("corr_stem", "corr_stem")
    r += _feature_att("corr_feature_att", "corr_feature_att")
    h = "cost_agg"
    for lvl in (1, 2, 3):
        for i in (0, 1):
            r += _basic_conv(f"{h}.conv{lvl}.{i}", f"{h}/conv{lvl}_{i}")
    r += _basic_conv(f"{h}.conv3_up", f"{h}/conv3_up", deconv=True)
    r += _basic_conv(f"{h}.conv2_up", f"{h}/conv2_up", deconv=True)
    r += _basic_conv(f"{h}.conv1_up", f"{h}/conv1_up", deconv=True, bn=False)
    for agg, fl in (("agg_0", "agg0"), ("agg_1", "agg1")):
        for i in range(3):
            r += _basic_conv(f"{h}.{agg}.{i}", f"{h}/{fl}_{i}")
    for att in ("feature_att_8", "feature_att_16", "feature_att_32", "feature_att_up_16",
                "feature_att_up_8"):
        r += _feature_att(f"{h}.{att}", f"{h}/{att}")
    r.append(("classifier.weight", "params", "classifier/kernel", _conv))
    return r


def _get(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def state_dict_from_jax(variables, diffusion: bool = True) -> dict[str, torch.Tensor]:
    """The port's ``ACVNet`` state dict from the JAX package's variables."""
    return state_dict_from_rules(variables, acv_rules(diffusion))


def pcw_state_dict_from_jax(variables, diffusion: bool = True,
                            use_concat_volume: bool = True) -> dict[str, torch.Tensor]:
    """The port's ``PCWNet`` state dict from the JAX package's variables.
    Without ``use_concat_volume`` the JAX model's 1-channel concat heads,
    which nothing reads, are left out."""
    return state_dict_from_rules(variables, pcw_rules(diffusion, use_concat_volume))


def igev_state_dict_from_jax(variables, diffusion: bool = True) -> dict[str, torch.Tensor]:
    """The port's ``IGEVStereo`` state dict from the JAX package's
    variables."""
    return state_dict_from_rules(variables, igev_rules(diffusion))


def state_dict_from_rules(variables, rules: list[Rule]) -> dict[str, torch.Tensor]:
    """A state dict from ``variables`` by the given rules."""
    sd = {}
    for key, coll, path, transform in rules:
        w = _get(variables[coll], path)
        if transform is not None:
            w = transform(w)
        sd[key] = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
        if key.endswith(".running_var"):
            sd[key.removesuffix("running_var") + "num_batches_tracked"] = torch.tensor(0)
    return sd
