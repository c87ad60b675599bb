"""Euler discrete and PNDM schedulers (port of the Euler part and the PNDM
timestep table of ``diffusion_feature_tpu/schedulers/diffusion.py``).

The schedule tables are built in numpy exactly as the JAX package builds
them, which reproduces diffusers' arrays: with linspace spacing Euler maps
t=50 to timestep 49 (``timesteps[1000 - t] == t - 1``); SDXL's leading
spacing with steps_offset 1 maps it to 50; PNDM's table carries diffusers'
duplicated entry.  Only the scaled-linear beta schedule (SD, SDXL) is
ported, and only what single-step img2img extraction needs: PNDM's PLMS
``step`` and the other schedulers (DDIM, DDPM, DPM-Solver) are not ported
yet (ROADMAP.md, Queue A: 'Other U-Net versions and multi-step paths').
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    timesteps: np.ndarray                  # descending
    sigmas: Optional[np.ndarray] = None    # Euler: one per timestep, then 0


class _Scheduler:
    """The scaled-linear schedule's cumulative alphas and the pipelines'
    img2img timestep selection, shared by the schedulers."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5,
                            config.num_train_timesteps, dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)

    def get_timesteps(self, state: SchedulerState, num_inference_steps: int,
                      strength: float) -> Tuple[np.ndarray, int]:
        """img2img timestep selection (the pipelines' ``get_timesteps``)."""
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        t_start = max(num_inference_steps - init_timestep, 0)
        return state.timesteps[t_start:], num_inference_steps - t_start


class EulerDiscreteScheduler(_Scheduler):
    """Euler discrete (SDXL default).  sigma_t = sqrt((1 - abar) / abar);
    img2img adds noise as x0 + sigma * eps and the model input is scaled by
    1 / sqrt(sigma^2 + 1)."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        super().__init__(config)
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


class PNDMScheduler(_Scheduler):
    """PNDM with skip_prk_steps (the SD-1.5 config): the timestep table with
    diffusers' duplicated second entry, which shifts the img2img timestep
    by one against Euler.  img2img noises as sqrt(abar) x0 + sqrt(1-abar) eps
    and leaves the model input unscaled."""

    def set_timesteps(self, num_inference_steps: int) -> SchedulerState:
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        base = (np.arange(0, num_inference_steps) * step_ratio).round() + self.config.steps_offset
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        return SchedulerState(plms.astype(np.int64))


def make_scheduler(kind: str, config: SchedulerConfig):
    """'euler' or 'pndm' (``models.registry.ModelSpec.scheduler``)."""
    return {'euler': EulerDiscreteScheduler, 'pndm': PNDMScheduler}[kind](config)


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype: the scalar is rounded to that dtype
    first, as JAX's ``jnp.asarray(value, dtype)`` does."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)
