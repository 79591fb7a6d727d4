"""Model registry.

Counterpart of ``diffuvolume_tpu/models/__init__.py``: the reference's string
registries (SceneFlow/models/__init__.py:5-8, KITTI12/models/__init__.py:5-9,
KITTI15's direct import) in one namespace, each name building the port's
module with the JAX registry's settings.  The modules are imported when a
name is built, so that importing a submodule of this package does not
import every model.
"""

from __future__ import annotations


def _acv(diffusion: bool):
    def build(max_disp: int = 192, **kw):
        from diffuvolume_tpu_torch.models.acv import ACVNet

        return ACVNet(max_disp=max_disp, diffusion=diffusion, **kw)
    return build


def _pcw(diffusion: bool, **fixed):
    def build(max_disp: int = 192, **kw):
        from diffuvolume_tpu_torch.models.pcw import PCWNet

        return PCWNet(max_disp=max_disp, diffusion=diffusion, **fixed, **kw)
    return build


def _igev(diffusion: bool):
    def build(max_disp: int = 192, **kw):
        from diffuvolume_tpu_torch.models.igev.model import IGEVStereo

        return IGEVStereo(max_disp=max_disp, diffusion=diffusion, **kw)
    return build


MODELS = {
    "acvnet": _acv(False),
    "acvnet_ddim": _acv(True),
    # the reference registers PCWNet as 'gwcnet-g' / 'gwcnet-gc'
    # (KITTI12/models/__init__.py:5-9)
    "gwcnet-g": _pcw(False, use_concat_volume=False),
    "gwcnet-gc": _pcw(False, use_concat_volume=True),
    "pcwnet_ddim": _pcw(True),
    "igev": _igev(False),
    "igev_ddim": _igev(True),
}


def build_model(name: str, **kwargs):
    """A new model of the registry's ``name`` (PyTorch's default
    initialisation, training mode, on the CPU in float32); ``kwargs`` go to
    the model (``max_disp``; ACVNet's ``attn_weights_only`` and
    ``freeze_attn_weights``, as the JAX train CLI passes them;
    ``pcwnet_ddim``'s ``use_concat_volume``)."""
    return MODELS[name](**kwargs)
