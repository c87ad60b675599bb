"""Forward DDIM inversion of a real image up to a target timestep (port of
``diffusion_feature_tpu/ddim_inversion.py``, the reference's
feature/components/ddim_inversion.py:7-45).

VAE-encode, then walk the inverted DDIM update up the 100-step ladder until
a timestep reaches ``stop_at_t``.  The reference pauses its feature store
during the walk; here each forward is the U-Net's plain one
(``UNet2DConditionModel.forward(plain=True)``): no taps, no store maps, every
attention on the fused path, as the JAX package's tap-free twin.  The
facade allows it for the epsilon-prediction U-Nets without micro-conditioning
('1-5', '2-1'), as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .schedulers.diffusion import DDIMScheduler, scalar_like


@torch.inference_mode()
def ddim_invert(extractor, img: torch.Tensor, cond, posterior_noise: torch.Tensor, *, stop_at_t, num_inference_steps: int = 100
                ) -> torch.Tensor:
    """Latents at (about) noise level ``stop_at_t``: the posterior sample of
    ``img`` (``posterior_noise`` a standard-normal fp32 draw of the latent
    shape), inverted step by step along the ascending DDIM ladder, up to and
    including the first timestep >= ``stop_at_t``, each step's U-Net on the
    conditioning object ``cond``."""
    latents = extractor.vae(img, posterior_noise)
    sched = DDIMScheduler(extractor.spec.scheduler_config)
    state = sched.set_timesteps(num_inference_steps)
    ascending = state.timesteps[::-1]
    step_size = sched.step_size(state)
    for i in range(1, num_inference_steps):
        t = int(ascending[i])
        a_t = sched.alphas_cumprod[max(0, t - step_size)]
        a_next = sched.alphas_cumprod[t]
        noise_pred = cond.forward(extractor.unet, latents, float(t), plain=True)
        # x(t) from x(t - step): the inverted DDIM update (reference
        # ddim_inversion.py:38-41)
        latents = ((latents - scalar_like(np.sqrt(1 - a_t), latents) * noise_pred)
                   * scalar_like(np.sqrt(a_next) / np.sqrt(a_t), latents)
                   + scalar_like(np.sqrt(1 - a_next), latents) * noise_pred)
        if t >= stop_at_t:
            break
    return latents
