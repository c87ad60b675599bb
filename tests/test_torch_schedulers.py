"""The port's scheduler configuration and timestep ladders against the JAX
package's, on the host (numpy tables, no model): Euler's trailing spacing,
``SchedulerConfig.from_dict`` and the spacings and PRK settings both
packages refuse."""

import dataclasses

import numpy as np
import pytest

from diffusion_feature_tpu.models.registry import get_model_spec as jax_model_spec
from diffusion_feature_tpu.schedulers import diffusion as jsched
from diffusion_feature_tpu_torch.models.registry import get_model_spec
from diffusion_feature_tpu_torch.schedulers import diffusion as sched_mod


def _configs(version, **changes):
    """(JAX config, port config) of ``version``'s scheduler with ``changes``."""
    jcfg = dataclasses.replace(jax_model_spec(version).scheduler_config, **changes)
    cfg = dataclasses.replace(get_model_spec(version).scheduler_config, **changes)
    return jcfg, cfg


@pytest.mark.parametrize('version', ['xl', '1-5'])
@pytest.mark.parametrize('steps', [1, 4, 50, 1000])
def test_euler_trailing_equals_jax(version, steps):
    """The trailing ladder, its sigmas and the initial noise scale (the
    plain largest sigma) equal JAX's exactly."""
    jcfg, cfg = _configs(version, timestep_spacing='trailing')
    ours = sched_mod.EulerDiscreteScheduler(cfg).set_timesteps(steps)
    ref = jsched.EulerDiscreteScheduler(jcfg).set_timesteps(steps)
    assert ours.timesteps.dtype == ref.timesteps.dtype == np.float32
    np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
    np.testing.assert_array_equal(ours.sigmas, ref.sigmas)
    assert ours.init_noise_sigma == ref.init_noise_sigma
    assert ours.timesteps[0] == 999 and len(ours.timesteps) == steps


def test_euler_trailing_worked_example():
    state = sched_mod.EulerDiscreteScheduler(
        sched_mod.SchedulerConfig(timestep_spacing='trailing')).set_timesteps(4)
    np.testing.assert_array_equal(state.timesteps, [999, 749, 499, 249])
    assert state.init_noise_sigma == pytest.approx(14.6146, abs=1e-4)
    assert state.init_noise_sigma == float(state.sigmas.max())


def test_config_from_dict_equals_jax():
    """A diffusers scheduler_config.json with keys neither package reads:
    every field equal to JAX's."""
    d = {'_class_name': 'PNDMScheduler', '_diffusers_version': '0.6.0', 'beta_end': 0.012,
         'beta_schedule': 'scaled_linear', 'beta_start': 0.00085, 'clip_sample': False,
         'num_train_timesteps': 1000, 'set_alpha_to_one': False, 'skip_prk_steps': True,
         'steps_offset': 1, 'trained_betas': None, 'timestep_spacing': 'leading',
         'solver_order': 3, 'prediction_type': 'v_prediction'}
    ours = sched_mod.SchedulerConfig.from_dict(d)
    ref = jsched.SchedulerConfig.from_dict(d)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(ref)])
    for f in dataclasses.fields(ref):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.solver_order == 3 and ours.skip_prk_steps
    assert sched_mod.SchedulerConfig(skip_prk_steps=True, solver_order=2) == \
        sched_mod.SchedulerConfig()


def test_pndm_without_skip_prk_steps_raises_in_both():
    jcfg, cfg = _configs('1-5', skip_prk_steps=False)
    with pytest.raises(NotImplementedError):
        jsched.PNDMScheduler(jcfg).set_timesteps(50)
    with pytest.raises(NotImplementedError):
        sched_mod.PNDMScheduler(cfg).set_timesteps(50)


def test_unknown_spacing_raises_in_both():
    jcfg, cfg = _configs('xl', timestep_spacing='karras')
    with pytest.raises(ValueError):
        jsched.EulerDiscreteScheduler(jcfg).set_timesteps(50)
    with pytest.raises(ValueError, match='karras'):
        sched_mod.EulerDiscreteScheduler(cfg).set_timesteps(50)
