"""One dataclass config system replacing the reference's argparse blocks.

The port's own copy of ``diffuvolume_tpu/config.py``.  Reference flag
surfaces: SceneFlow/main.py:27-46, KITTI12/main.py:23-44,
KITTI15/train_stereo.py:210-245.  Defaults reproduce the published recipes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: str = "acv"  # acv | pcw | igev
    max_disp: int = 192
    diffusion: bool = True
    timesteps: int = 1000
    sampling_steps: int = 5
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "sceneflow"  # sceneflow | kitti12 | kitti15 | eth3d | middlebury
    datapath: str = "/data/sceneflow"
    trainlist: str | None = None
    testlist: str | None = None
    batch_size: int = 24  # reference: 23 over 6 GPUs (uneven)
    test_batch_size: int = 4
    crop_h: int = 256
    crop_w: int = 512


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    lrepochs: str = "16,24,32,40,48:2"  # milestone decay (main.py:34)
    epochs: int = 48
    optimizer: str = "adam"  # adam | adamw
    weight_decay: float = 1e-5
    grad_clip: float | None = None  # KITTI15 uses 1.0
    bf16: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data_axis: int | None = None  # None → all devices
    volume_axis: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    parallel: ParallelConfig = ParallelConfig()
    logdir: str = "./checkpoints"
    seed: int = 1
    resume: bool = False
    loadckpt: str | None = None


SCENEFLOW_TRAIN = ExperimentConfig()

KITTI12_FINETUNE = ExperimentConfig(
    model=ModelConfig(backbone="pcw", sampling_steps=3),
    data=DataConfig(dataset="kitti12", datapath="/data/kitti12", batch_size=4),
    optim=OptimConfig(lr=1e-3, lrepochs="200:10", epochs=300),
)

KITTI15_FINETUNE = ExperimentConfig(
    model=ModelConfig(backbone="igev", sampling_steps=2),
    data=DataConfig(dataset="kitti15", datapath="/data/kitti15", batch_size=4,
                    crop_h=320, crop_w=736),
    optim=OptimConfig(lr=2e-4, optimizer="adamw", weight_decay=1e-5,
                      grad_clip=1.0, bf16=True),
)
