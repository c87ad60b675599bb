"""The PyTorch port's ``DiffusionSegmentor`` with prompt tuning against the
JAX package's, at fp32 on the CPU: the loss of one training step and its
gradient with respect to ``meta_prompt``, which reaches it through the
extraction step (``test-sd`` at 64^2).

Tolerances: 1e-4 relative for the loss, 1e-3 max-relative error for the
gradient (tests/test_grad_parity.py's rule for a tensor with signal).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from diffusion_feature_tpu.tasks.segmentation import segmentor as jax_segmentor
from diffusion_feature_tpu_torch.tasks.segmentation import seg_head_from_jax
from diffusion_feature_tpu_torch.tasks.segmentation.segmentor import DiffusionSegmentor
from port_parity import jax_facade, jax_noise, load_jax_params
from test_torch_segmentation import (CHANNELS, CLASSES, SEG_DF, SEG_FEATURE_LAYERS, SEG_LAYERS,
                                     SEG_SIZE, _jax_init, _rand, _randomise)

VALUE_TOL, GRAD_TOL = 1e-4, 1e-3
SEG_SEED = 0


def test_segmentor_prompt_tuning_loss_and_meta_prompt_grad_match_jax(monkeypatch):
    """``DiffusionSegmentor.loss`` with prompt tuning (the features carry the
    gradient of ``meta_prompt`` through the extraction step) against the
    JAX segmentor's ``loss`` and ``jax.grad``, on the same extractor
    parameters, head parameters, meta prompt and noise, dropout off.  Both
    extractors keep fp32 features (the JAX facade of ``port_parity`` does;
    the port's is set so) so the comparison runs at fp32."""
    jfe = jax_facade(SEG_LAYERS, 'test-sd', SEG_SIZE, SEG_SEED)
    monkeypatch.setattr(jax_segmentor, 'FeatureExtractor', lambda **kw: jfe)
    jseg = jax_segmentor.DiffusionSegmentor(SEG_DF, SEG_FEATURE_LAYERS, num_classes=CLASSES,
                                            head_channels=CHANNELS, prompt='a photo',
                                            prompt_tuning=True)
    # the state init_state would make, without its extract and its op-by-op
    # Flax init: the head's variables from one compiled init, redrawn
    shapes = {'up-level0-repeat1-res-out': (1, 64, 16, 16),
              'up-level1-repeat0-vit-block0-cross-q': (1, 32, 32, 32)}
    variables = _jax_init(jseg.head, ({k: jnp.zeros(v) for k, v in shapes.items()},))
    params = {'head': _randomise(variables['params'], 6),
              'meta_prompt': _rand(12, *np.shape(jseg.prompt_embeds[0]))}
    stats = _randomise(variables['batch_stats'], 7)
    jseg.head_loss = jax.jit(jseg.head_loss)

    seg = DiffusionSegmentor(SEG_DF, SEG_FEATURE_LAYERS, num_classes=CLASSES,
                             head_channels=CHANNELS, prompt='a photo', prompt_tuning=True,
                             device='cpu')
    assert seg.extractor.dtype == torch.float32 and not seg.extractor.train_unet
    assert seg.extractor.text_encoders == ()
    load_jax_params(jfe, seg.extractor)
    seg.extractor.feature_dtype = None
    seg.init_state()
    seg.head.load_state_dict(seg_head_from_jax(params['head'], stats))
    with torch.no_grad():
        seg.meta_prompt.copy_(torch.from_numpy(params['meta_prompt']))
    fe = seg.extractor

    def injected_extract(prompts, batch_size, image, image_type, t, use_control):
        """The port's extract on the JAX facade's draws of its first extract
        (the images are at the extractor's size already: no resize)."""
        lat = SEG_SIZE // fe.vae_scale
        noise = jax_noise(SEG_SEED, (batch_size, fe.spec.vae.latent_channels, lat, lat))
        return fe._step(image, fe._step_conditioning(prompts, batch_size), fe._step_kit(t),
                        *noise, fe.feature_dtype)

    monkeypatch.setattr(fe, 'extract', injected_extract)
    images = np.random.RandomState(8).rand(2, 3, SEG_SIZE, SEG_SIZE).astype(np.float32) * 2 - 1
    labels = np.random.RandomState(9).randint(0, CLASSES, (2, SEG_SIZE, SEG_SIZE))
    labels[:, :4] = 255

    def jax_loss(p):
        return jseg.loss(p, stats, jnp.asarray(images), jnp.asarray(labels), None)

    (ref, (ref_parts, _)), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    ours, parts = seg.loss(torch.from_numpy(images), torch.from_numpy(labels))
    ours.backward()
    assert abs(float(ours.detach()) - float(ref)) < VALUE_TOL * abs(float(ref))
    g = seg.meta_prompt.grad.numpy()
    ref_g = np.asarray(grads['meta_prompt'])
    assert np.abs(ref_g).max() > 0 and np.abs(g - ref_g).max() / np.abs(ref_g).max() < GRAD_TOL
    assert set(seg.trainable()) == {f'head.{k}' for k, _ in seg.head.named_parameters()} | {
        'meta_prompt'}
