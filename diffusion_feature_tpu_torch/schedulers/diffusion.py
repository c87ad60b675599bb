"""Euler discrete scheduler (port of the Euler part of
``diffusion_feature_tpu/schedulers/diffusion.py``).

The schedule tables are built in numpy exactly as the JAX package builds
them, which reproduces diffusers' arrays: with linspace spacing Euler maps
t=50 to timestep 49 (``timesteps[1000 - t] == t - 1``); SDXL's leading
spacing with steps_offset 1 maps it to 50.  Only the scaled-linear beta
schedule (SD, SDXL) is ported.  The other schedulers (PNDM, DDIM, DDPM,
DPM-Solver) are not ported yet (ROADMAP.md, Queue A: 'Other U-Net versions
and multi-step paths').
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    timestep_spacing: str = 'linspace'
    steps_offset: int = 0


@dataclasses.dataclass
class SchedulerState:
    """Per-``set_timesteps`` tables (host numpy)."""
    timesteps: np.ndarray            # descending
    sigmas: np.ndarray               # one per timestep, then 0


class EulerDiscreteScheduler:
    """Euler discrete (SDXL default).  sigma_t = sqrt((1 - abar) / abar);
    img2img adds noise as x0 + sigma * eps and the model input is scaled by
    1 / sqrt(sigma^2 + 1)."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                            config.num_train_timesteps, dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self._train_sigmas = np.sqrt((1 - self.alphas_cumprod) / self.alphas_cumprod)

    def set_timesteps(self, num_inference_steps: int) -> SchedulerState:
        n = self.config.num_train_timesteps
        spacing = self.config.timestep_spacing
        if spacing == 'linspace':
            timesteps = np.linspace(0, n - 1, num_inference_steps, dtype=np.float32)[::-1].copy()
        elif spacing == 'leading':
            step_ratio = n // num_inference_steps
            timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(
                np.float32)
            timesteps += self.config.steps_offset
        else:
            raise NotImplementedError(f'timestep spacing {spacing!r} is not ported yet')
        sigmas = np.interp(timesteps, np.arange(n), self._train_sigmas)
        return SchedulerState(timesteps, np.concatenate([sigmas, [0.0]]).astype(np.float32))

    def get_timesteps(self, state: SchedulerState, num_inference_steps: int,
                      strength: float) -> Tuple[np.ndarray, int]:
        """img2img timestep selection (the pipelines' ``get_timesteps``)."""
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        t_start = max(num_inference_steps - init_timestep, 0)
        return state.timesteps[t_start:], num_inference_steps - t_start

    def sigma_index(self, state: SchedulerState, timestep) -> int:
        return int(np.nonzero(np.isclose(state.timesteps, float(timestep)))[0][0])

    def add_noise(self, state: SchedulerState, sample: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        sigma = float(state.sigmas[self.sigma_index(state, timestep)])
        return sample + scalar_like(sigma, sample) * noise

    def scale_model_input(self, state: SchedulerState, sample: torch.Tensor,
                          timestep) -> torch.Tensor:
        sigma = float(state.sigmas[self.sigma_index(state, timestep)])
        return sample / scalar_like(np.sqrt(sigma ** 2 + 1), sample)


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype: the scalar is rounded to that dtype
    first, as JAX's ``jnp.asarray(value, dtype)`` does."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)
