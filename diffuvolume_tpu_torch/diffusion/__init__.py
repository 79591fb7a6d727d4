from diffuvolume_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    cosine_beta_schedule,
    ddim_step_coefficients,
    ddim_time_pairs,
    extract,
    make_schedule,
    predict_noise_from_start,
    q_sample,
)
from diffuvolume_tpu_torch.diffusion.codec import encode_disparity_volume
from diffuvolume_tpu_torch.diffusion.ddim import (
    KITTI12_DDIM,
    KITTI15_DDIM,
    SCENEFLOW_DDIM,
    DDIMConfig,
    ddim_sample,
)
