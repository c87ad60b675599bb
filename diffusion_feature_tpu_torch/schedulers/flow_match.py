"""FlowMatchEulerDiscrete, Flux.1-dev's rectified-flow schedule (port of
``diffusion_feature_tpu/schedulers/flow_match.py``).

The tables are built on the host in float64 numpy and stored as float32, as
the port's other schedulers do: sigmas from 1 down to 1/1000 (or the
caller's), shifted by the resolution-dependent ``mu`` (dynamic shifting) or
the fixed ``shift``, timesteps = sigma * 1000, and a terminal sigma of 0.
img2img noising is x_t = (1 - sigma) x0 + sigma eps, and the Euler step
is prev = sample + (sigma_next - sigma) * model_output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .diffusion import scalar_like


@dataclasses.dataclass(frozen=True)
class FlowMatchConfig:
    num_train_timesteps: int = 1000
    shift: float = 3.0
    use_dynamic_shifting: bool = True
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


def calculate_shift(image_seq_len: int, cfg: FlowMatchConfig) -> float:
    """Flux's resolution-dependent schedule shift (mu), linear in the
    number of image tokens."""
    m = (cfg.max_shift - cfg.base_shift) / (cfg.max_image_seq_len - cfg.base_image_seq_len)
    b = cfg.base_shift - m * cfg.base_image_seq_len
    return image_seq_len * m + b


@dataclasses.dataclass
class FlowMatchState:
    num_inference_steps: int
    timesteps: np.ndarray   # descending, sigma * 1000, float32
    sigmas: np.ndarray      # descending, with the terminal 0 appended, float32
    init_noise_sigma: float = 1.0


class FlowMatchEulerDiscreteScheduler:
    order = 1
    init_noise_sigma = 1.0   # pure noise at sigma 1 (rectified flow)

    def __init__(self, config: FlowMatchConfig = FlowMatchConfig()):
        self.config = config

    def set_timesteps(self, num_inference_steps: int, mu: Optional[float] = None,
                      sigmas: Optional[np.ndarray] = None) -> FlowMatchState:
        """The ladder of ``num_inference_steps``: ``sigmas`` (default
        linspace(1, 1/1000)) shifted by ``mu`` (dynamic shifting; 1.0 when
        not given, as in the JAX package) or by the fixed ``shift``."""
        n = self.config.num_train_timesteps
        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / n, num_inference_steps)
        sigmas = np.asarray(sigmas, np.float64)
        if self.config.use_dynamic_shifting:
            mu = 1.0 if mu is None else mu
            sigmas = np.exp(mu) / (np.exp(mu) + (1 / sigmas - 1))
        else:
            s = self.config.shift
            sigmas = s * sigmas / (1 + (s - 1) * sigmas)
        timesteps = sigmas * n
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return FlowMatchState(num_inference_steps, timesteps.astype(np.float32), sigmas)

    def get_timesteps(self, state: FlowMatchState, num_inference_steps: int,
                      strength: float) -> Tuple[np.ndarray, int]:
        """The img2img tail of the ladder at ``strength`` and its length."""
        init_timestep = min(num_inference_steps * strength, num_inference_steps)
        t_start = int(max(num_inference_steps - init_timestep, 0))
        return state.timesteps[t_start * self.order:], num_inference_steps - t_start

    def _index(self, state: FlowMatchState, timestep) -> int:
        return int(np.nonzero(np.isclose(state.timesteps, float(timestep)))[0][0])

    def scale_noise(self, state: FlowMatchState, sample: torch.Tensor, noise: torch.Tensor,
                    timestep) -> torch.Tensor:
        """img2img noise injection: x_t = (1 - sigma) x0 + sigma eps."""
        sigma = float(state.sigmas[self._index(state, timestep)])
        return scalar_like(1.0 - sigma, sample) * sample + scalar_like(sigma, sample) * noise

    add_noise = scale_noise

    def scale_model_input(self, state: FlowMatchState, sample: torch.Tensor,
                          timestep) -> torch.Tensor:
        return sample

    def step(self, state: FlowMatchState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor):
        """The Euler step from ``timestep`` to the next sigma; returns
        (prev_sample, state)."""
        i = self._index(state, timestep)
        sigma, sigma_next = float(state.sigmas[i]), float(state.sigmas[i + 1])
        return sample + scalar_like(sigma_next - sigma, sample) * model_output, state
