from diffuvolume_tpu_torch.parallel.ddp import (
    free_port,
    from_env,
    init,
    shutdown,
    sync_batch_norm,
)
from diffuvolume_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "free_port", "from_env", "init", "make_mesh", "shutdown", "sync_batch_norm"]
