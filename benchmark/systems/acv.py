"""ACVNet-DDIM: the reference network and the program's names for it."""

from benchmark.reference import nets

# The program's registry names, fold and two-pass entry.
PORT = {"baseline": "acvnet", "ddim": "acvnet_ddim",
        "fold": ("diffuvolume_tpu_torch.models.acv_fold", "fold_acv"),
        "entry": "acv_ddim_inference"}


def reference(cfg: dict, diffusion: bool):
    m = cfg["model"]
    return nets.ACVNet(m["max_disp"], diffusion, m["scale"], m["num_groups"],
                       m["concat_channels"])


def port_kwargs(cfg: dict) -> dict:
    return {"max_disp": cfg["model"]["max_disp"]}
