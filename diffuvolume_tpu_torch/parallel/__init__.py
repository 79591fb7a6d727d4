from diffuvolume_tpu_torch.parallel.ddp import (
    DataParallel,
    free_port,
    from_env,
    init,
    shutdown,
    sync_batch_norm,
)

__all__ = ["DataParallel", "free_port", "from_env", "init", "shutdown", "sync_batch_norm"]
