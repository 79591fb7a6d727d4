"""PCWNet-DDIM: the reference network and the program's names for it."""

from benchmark.reference import nets

# The program's registry names, fold and two-pass entry.
PORT = {"baseline": "gwcnet-gc", "ddim": "pcwnet_ddim",
        "fold": ("diffuvolume_tpu_torch.models.pcw_fold", "fold_pcw"),
        "entry": "pcw_ddim_inference"}


def reference(cfg: dict, diffusion: bool):
    m = cfg["model"]
    return nets.PCWNet(m["max_disp"], diffusion, m["scale"], m["num_groups"],
                       m["use_concat_volume"])


def port_kwargs(cfg: dict) -> dict:
    return {"max_disp": cfg["model"]["max_disp"]}
