"""Euler discrete, PNDM, DDIM, DDPM and DPM-Solver++ (2M) schedulers (port
of ``diffusion_feature_tpu/schedulers/diffusion.py``).

The schedule tables are built in numpy exactly as the JAX package builds
them, which reproduces diffusers' arrays: with linspace spacing Euler maps
t=50 to timestep 49 (``timesteps[1000 - t] == t - 1``); SDXL's leading
spacing with steps_offset 1 maps it to 50; PNDM's table carries diffusers'
duplicated entry; DPM-Solver's rounded linspace maps t=50 to 50; Euler's
trailing spacing ends its ladder at timestep 999 and, like linspace, scales
the initial noise by the plain largest sigma.  The beta
schedules are scaled-linear (SD, SD-2.1, SDXL), linear (PixArt) and the
capped cosine ``squaredcos_cap_v2`` (DeepFloyd IF).
``step`` works on a state of any step count (the facade's
``denoising_from`` walk switches to a 100-step state); PLMS history and
DPM-Solver's last two x0 predictions ride the state (``ets``, ``counter``,
``cur_sample``), which ``step`` returns updated and never mutates.  DDPM
takes HunyuanDiT's fixed-small variance or DeepFloyd IF's learned range,
with IF's dynamic thresholding of the x0 prediction.
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
    beta_schedule: str = 'scaled_linear'   # or 'linear', 'squaredcos_cap_v2'
    prediction_type: str = 'epsilon'   # or 'v_prediction' / 'sample'
    timestep_spacing: str = 'linspace'
    steps_offset: int = 0
    skip_prk_steps: bool = True            # PNDM: PLMS only (False raises)
    clip_sample: bool = False
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    variance_type: str = 'fixed_small'     # DDPM: or 'learned_range'
    solver_order: int = 2                  # DPM-Solver

    @staticmethod
    def from_dict(d: dict) -> 'SchedulerConfig':
        """The config from a diffusers-style dict; keys that are no field
        (``_class_name``, ``set_alpha_to_one``, ...) are dropped."""
        names = {f.name for f in dataclasses.fields(SchedulerConfig)}
        return SchedulerConfig(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class SchedulerState:
    """Per-``set_timesteps`` tables (host numpy) and the PLMS history."""
    num_inference_steps: int
    timesteps: np.ndarray                  # descending
    sigmas: Optional[np.ndarray] = None    # Euler: one per timestep, then 0
    init_noise_sigma: float = 1.0          # generation's initial latent scale
    ets: tuple = ()                        # PLMS: the last 4 model outputs;
    #                                        DPM-Solver: the last 2 (x0, t)
    counter: int = 0
    cur_sample: Optional[torch.Tensor] = None


def make_betas(schedule: str, beta_start: float, beta_end: float, n: int) -> np.ndarray:
    """The training betas (JAX ``make_betas``), float64."""
    if schedule == 'linear':
        return np.linspace(beta_start, beta_end, n, dtype=np.float64)
    if schedule == 'scaled_linear':
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2
    if schedule == 'squaredcos_cap_v2':
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(n, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / n) / alpha_bar(ts / n), 0.999)
    raise ValueError(f'unknown beta schedule {schedule!r}')


class _Scheduler:
    """The beta schedule's cumulative alphas, the leading-spacing timestep
    table and the pipelines' img2img timestep selection, shared by the
    schedulers."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        betas = make_betas(config.beta_schedule, config.beta_start, config.beta_end,
                           config.num_train_timesteps)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha_cumprod = 1.0

    def set_timesteps(self, num_inference_steps: int) -> SchedulerState:
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        return SchedulerState(num_inference_steps,
                              timesteps.astype(np.int64) + self.config.steps_offset)

    def get_timesteps(self, state: SchedulerState, num_inference_steps: int,
                      strength: float) -> Tuple[np.ndarray, int]:
        """img2img timestep selection (the pipelines' ``get_timesteps``)."""
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        t_start = max(num_inference_steps - init_timestep, 0)
        return state.timesteps[t_start:], num_inference_steps - t_start

    def step_size(self, state: SchedulerState) -> int:
        return self.config.num_train_timesteps // state.num_inference_steps

    def add_noise(self, state: SchedulerState, sample: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        """sqrt(abar_t) x0 + sqrt(1 - abar_t) eps (the DDPM family's)."""
        a = float(self.alphas_cumprod[int(timestep)])
        return (scalar_like(np.sqrt(a), sample) * sample
                + scalar_like(np.sqrt(1 - a), sample) * noise)

    def scale_model_input(self, state: SchedulerState, sample: torch.Tensor,
                          timestep) -> torch.Tensor:
        return sample

    def _predict_x0_eps(self, model_output, sample, alpha_prod_t):
        """(x0, eps) under the configured prediction type."""
        sqrt_a = scalar_like(np.sqrt(alpha_prod_t), sample)
        sqrt_1ma = scalar_like(np.sqrt(1 - alpha_prod_t), sample)
        pt = self.config.prediction_type
        if pt == 'epsilon':
            return (sample - sqrt_1ma * model_output) / sqrt_a, model_output
        if pt == 'v_prediction':
            return (sqrt_a * sample - sqrt_1ma * model_output,
                    sqrt_a * model_output + sqrt_1ma * sample)
        if pt == 'sample':
            return model_output, (sample - sqrt_a * model_output) / sqrt_1ma
        raise ValueError(pt)


class EulerDiscreteScheduler(_Scheduler):
    """Euler discrete (SD-2.1, SDXL, Playground v2).  sigma_t =
    sqrt((1 - abar) / abar); img2img adds noise as x0 + sigma * eps and the
    model input is scaled by 1 / sqrt(sigma^2 + 1)."""

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
        elif spacing == 'trailing':
            step_ratio = n / num_inference_steps
            timesteps = np.arange(n, 0, -step_ratio).round().astype(np.float32) - 1
        else:
            raise ValueError(f'unknown timestep spacing {spacing!r}')
        sigmas = np.concatenate([np.interp(timesteps, np.arange(n), self._train_sigmas),
                                 [0.0]]).astype(np.float32)
        # diffusers scales the initial latents by the inference schedule's
        # largest sigma: plain for linspace and trailing spacing,
        # sqrt(max^2 + 1) for leading
        smax = float(sigmas.max())
        init = smax if spacing in ('linspace', 'trailing') else float(np.sqrt(smax ** 2 + 1))
        return SchedulerState(num_inference_steps, timesteps, sigmas, init_noise_sigma=init)

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

    def step(self, state: SchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor):
        """One Euler step from ``timestep`` to the next sigma of ``state``;
        returns (prev_sample, state)."""
        i = self.sigma_index(state, timestep)
        sigma, sigma_next = float(state.sigmas[i]), float(state.sigmas[i + 1])
        pt = self.config.prediction_type
        if pt == 'epsilon':
            x0 = sample - scalar_like(sigma, sample) * model_output
        elif pt == 'v_prediction':
            c = sigma ** 2 + 1
            x0 = (model_output * scalar_like(-sigma / np.sqrt(c), sample)
                  + sample / scalar_like(c, sample))
        else:
            x0 = model_output
        deriv = (sample - x0) / scalar_like(sigma, sample)
        return sample + deriv * scalar_like(sigma_next - sigma, sample), state


class PNDMScheduler(_Scheduler):
    """PNDM with skip_prk_steps (the SD-1.5 config): PLMS only.  The
    timestep table carries diffusers' duplicated second entry, which shifts
    the img2img timestep by one against Euler.  img2img noises as
    sqrt(abar) x0 + sqrt(1-abar) eps and leaves the model input unscaled."""

    def set_timesteps(self, num_inference_steps: int) -> SchedulerState:
        if not self.config.skip_prk_steps:
            raise NotImplementedError('PRK warm-up steps: no supported model uses them '
                                      '(skip_prk_steps=False)')
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        base = (np.arange(0, num_inference_steps) * step_ratio).round() + self.config.steps_offset
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        return SchedulerState(num_inference_steps, plms.astype(np.int64))

    def step(self, state: SchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor):
        """PLMS linear multistep (diffusers ``step_plms``): the first call
        steps with its own output, the second (the duplicated timestep)
        re-steps the first call's sample with the mean of both outputs, the
        later ones blend the last 2, 3 or 4 outputs.  Returns
        (prev_sample, the state with the history updated)."""
        t = int(timestep)
        prev_t = t - self.step_size(state)
        ets, counter, cur_sample = state.ets, state.counter, state.cur_sample
        if counter != 1:
            ets = (ets + (model_output,))[-4:]
        else:
            prev_t, t = t, t + self.step_size(state)
        if len(ets) == 1 and counter == 0:
            out, cur_sample = model_output, sample
        elif len(ets) == 1 and counter == 1:
            out, sample, cur_sample = (model_output + ets[-1]) / 2, cur_sample, None
        elif len(ets) == 2:
            out = (3 * ets[-1] - ets[-2]) / 2
        elif len(ets) == 3:
            out = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            out = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24
        prev = self._prev_sample(sample, t, prev_t, out)
        return prev, dataclasses.replace(state, ets=ets, counter=counter + 1,
                                         cur_sample=cur_sample)

    def _prev_sample(self, sample, t: int, prev_t: int, model_output):
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev_t]) if prev_t >= 0 else 1.0
        beta_t, beta_prev = 1 - a_t, 1 - a_prev
        if self.config.prediction_type == 'v_prediction':
            model_output = (scalar_like(np.sqrt(a_t), sample) * model_output
                            + scalar_like(np.sqrt(beta_t), sample) * sample)
        denom = a_t * np.sqrt(beta_prev) + np.sqrt(a_t * beta_t * a_prev)
        return (scalar_like(np.sqrt(a_prev / a_t), sample) * sample
                - scalar_like((a_prev - a_t) / denom, sample) * model_output)


class DDIMScheduler(_Scheduler):
    """Deterministic DDIM (eta=0); its ladder and ``final_alpha_cumprod``
    are what DDIM inversion walks (``ddim_inversion.py``)."""

    def step(self, state: SchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor):
        t = int(timestep)
        prev_t = t - self.step_size(state)
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev_t]) if prev_t >= 0 else self.final_alpha_cumprod
        x0, eps = self._predict_x0_eps(model_output, sample, a_t)
        return (scalar_like(np.sqrt(a_prev), sample) * x0
                + scalar_like(np.sqrt(1 - a_prev), sample) * eps), state


class DDPMScheduler(_Scheduler):
    """Ancestral DDPM (HunyuanDiT's and DeepFloyd IF's pipeline scheduler):
    the leading-spacing ladder, DDPM-family noising, and a step that takes
    the posterior mean from the x0 prediction and adds the variance's share
    of ``noise``, a standard-normal draw of the sample's shape, at every
    timestep above 0.  The x0 prediction is dynamically thresholded
    (``thresholding``, IF's) or clamped to [-1, 1] (``clip_sample``).  The
    variance is fixed-small, or with ``variance_type='learned_range'`` (IF)
    a model output of twice the sample's channels carries it in its second
    half, interpolating between the fixed-small and the current-beta log
    variances."""

    def _threshold(self, x0: torch.Tensor) -> torch.Tensor:
        """Imagen's dynamic thresholding in fp32 (the JAX ``_threshold``):
        s = clip(quantile(|x0|, ratio), 1, sample_max_value) per sample,
        x0 clamped to [-s, s] and divided by s.  ``torch.quantile``
        interpolates linearly, as ``jnp.quantile`` does."""
        b = x0.shape[0]
        flat = x0.float().abs().reshape(b, -1)
        s = torch.quantile(flat, self.config.dynamic_thresholding_ratio, dim=1)
        s = s.clamp(1.0, self.config.sample_max_value).reshape((b,) + (1,) * (x0.dim() - 1))
        return (x0.float().clamp(-s, s) / s).to(x0.dtype)

    def step(self, state: SchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None):
        t = int(timestep)
        prev_t = t - self.step_size(state)
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev_t]) if prev_t >= 0 else 1.0
        current_alpha = a_t / a_prev
        current_beta = 1 - current_alpha
        predicted_variance = None
        if (self.config.variance_type == 'learned_range'
                and model_output.shape[1] == sample.shape[1] * 2):
            model_output, predicted_variance = model_output.chunk(2, dim=1)
        x0, _ = self._predict_x0_eps(model_output, sample, a_t)
        if self.config.thresholding:
            x0 = self._threshold(x0)
        elif self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        prev = (scalar_like(np.sqrt(a_prev) * current_beta / (1 - a_t), sample) * x0
                + scalar_like(np.sqrt(current_alpha) * (1 - a_prev) / (1 - a_t), sample) * sample)
        if t > 0 and noise is not None:
            var = max((1 - a_prev) / (1 - a_t) * current_beta, 1e-20)
            if predicted_variance is not None:
                # in fp32, the product cast to the sample's dtype
                min_log, max_log = float(np.log(var)), float(np.log(max(current_beta, 1e-20)))
                frac = (predicted_variance.float() + 1) / 2
                log_var = frac * max_log + (1 - frac) * min_log
                prev = prev + (torch.exp(0.5 * log_var) * noise.float()).to(sample.dtype)
            else:
                prev = prev + scalar_like(np.sqrt(var), sample) * noise.to(sample.dtype)
        return prev, state


class DPMSolverMultistepScheduler(_Scheduler):
    """DPM-Solver++ (2M), the PixArt pipelines' scheduler: the rounded
    linspace ladder, DDPM-family noising, and a first-order step, then
    second-order ones from the last two x0 predictions (kept in the
    state's ``ets`` with their timesteps)."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        super().__init__(config)
        self.alpha_t = np.sqrt(self.alphas_cumprod)
        self.sigma_t = np.sqrt(1 - self.alphas_cumprod)
        self.lambda_t = np.log(self.alpha_t) - np.log(self.sigma_t)

    def set_timesteps(self, num_inference_steps: int) -> SchedulerState:
        n = self.config.num_train_timesteps
        timesteps = np.linspace(0, n - 1, num_inference_steps + 1).round()[::-1][:-1]
        return SchedulerState(num_inference_steps, timesteps.astype(np.int64))

    def prev_timestep(self, state: SchedulerState, timestep) -> int:
        """The ladder's next timestep after ``timestep`` (0 after the last)."""
        ts = state.timesteps
        idx = int(np.nonzero(ts == int(timestep))[0][0])
        return int(ts[idx + 1]) if idx + 1 < len(ts) else 0

    def step(self, state: SchedulerState, model_output: torch.Tensor, timestep,
             sample: torch.Tensor):
        """One multistep DPM-Solver++ update to the ladder's next timestep:
        prev = (sigma_p / sigma_s) sample - alpha_p expm1(-h) D, with D the
        x0 prediction, or from the second step on its extrapolation
        x0 + (x0 - x0_prev) / (2r) over the log-SNR steps' ratio r.
        Returns (prev_sample, the state with the x0 history updated)."""
        t = int(timestep)
        prev_t = self.prev_timestep(state, t)
        x0, _ = self._predict_x0_eps(model_output, sample, float(self.alphas_cumprod[t]))
        h = self.lambda_t[prev_t] - self.lambda_t[t]
        ets = (state.ets + ((x0, t),))[-2:]
        d = x0
        if len(ets) >= 2:
            x0_prev, t_prev = ets[-2]
            r = (self.lambda_t[t] - self.lambda_t[int(t_prev)]) / h if h != 0 else 1.0
            if r != 0:
                d = x0 + (x0 - x0_prev) / scalar_like(2 * r, x0)
        prev = (scalar_like(self.sigma_t[prev_t] / self.sigma_t[t], sample) * sample
                - scalar_like(self.alpha_t[prev_t] * np.expm1(-h), sample) * d)
        return prev, dataclasses.replace(state, ets=ets, counter=state.counter + 1)


def make_scheduler(kind: str, config):
    """'euler', 'pndm', 'ddim', 'ddpm', 'dpmsolver' (``config`` a
    ``SchedulerConfig``) or 'flowmatch' (a ``flow_match.FlowMatchConfig``)
    (``models.registry.ModelSpec.scheduler``)."""
    from .flow_match import FlowMatchEulerDiscreteScheduler   # it imports this module
    return {'euler': EulerDiscreteScheduler, 'pndm': PNDMScheduler, 'ddim': DDIMScheduler,
            'ddpm': DDPMScheduler, 'dpmsolver': DPMSolverMultistepScheduler,
            'flowmatch': FlowMatchEulerDiscreteScheduler}[kind](config)


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype: the scalar is rounded to that dtype
    first, as JAX's ``jnp.asarray(value, dtype)`` does."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)
