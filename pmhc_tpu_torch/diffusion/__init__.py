from pmhc_tpu_torch.diffusion.noise import gen_noise, remove_noise, remove_noise_scalars
from pmhc_tpu_torch.diffusion.sampler import sample
from pmhc_tpu_torch.diffusion.schedule import (
    DiffusionConfig,
    ScheduleTables,
    StridedTables,
    strided_timesteps,
)

__all__ = [
    "DiffusionConfig",
    "ScheduleTables",
    "StridedTables",
    "gen_noise",
    "remove_noise",
    "remove_noise_scalars",
    "sample",
    "strided_timesteps",
]
