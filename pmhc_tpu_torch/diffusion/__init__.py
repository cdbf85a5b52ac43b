from pmhc_tpu_torch.diffusion.loss import diffusion_loss
from pmhc_tpu_torch.diffusion.noise import add_noise, gen_noise, remove_noise, remove_noise_scalars
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
    "add_noise",
    "diffusion_loss",
    "gen_noise",
    "remove_noise",
    "remove_noise_scalars",
    "sample",
    "strided_timesteps",
]
