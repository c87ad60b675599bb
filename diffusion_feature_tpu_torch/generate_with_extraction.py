"""Background extraction: features kept while an image is generated (the
PyTorch port's counterpart of the root ``generate_with_extraction.py``):

    python -m diffusion_feature_tpu_torch.generate_with_extraction \\
        --version 1-5 --steps 50 --store_steps 1 10 20 30 40 --output generated.png

A text-to-image ``sample`` runs with the taps of ``--layer`` at every
denoiser call (the U-Net's, DeepFloyd IF's in pixel space, or a DiT's:
PixArt, HunyuanDiT, Flux), keeps the calls numbered in ``--store_steps``
(1-based; PNDM's 50 steps make 51 calls, DPM-Solver's and DDPM's 50),
writes the image and prints one ``layer step=N shape`` line per kept
feature (reference generate_with_extraction.py:21-48).  The JAX CLI's
flags and defaults, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain twins).  Layer ids the version does not have are dropped
with a warning on stderr (the JAX CLI refuses them), so the SD-1.5 default
``--layer`` runs on any U-Net version (a DiT version then keeps no
layer: pass its ``vit-block{i}-*`` ids).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .configs import resolve_layer_config
from .facade import FeatureExtractor
from .taps import TapSpec, declared_ids


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--layer', type=str, default='15-practical')
    parser.add_argument('--version', type=str, default='1-5')
    parser.add_argument('--prompt', type=str,
                        default='a photograph of an astronaut riding a horse')
    parser.add_argument('--img_size', type=int, default=512)
    parser.add_argument('--steps', type=int, default=50)
    parser.add_argument('--guidance_scale', type=float, default=7.5)
    parser.add_argument('--store_steps', type=int, nargs='+', default=[1, 10, 20, 30, 40])
    parser.add_argument('--dtype', type=str, default='bfloat16')
    parser.add_argument('--weights', type=str, default=None)
    parser.add_argument('--weights_variant', type=str, default=None)
    parser.add_argument('--output', type=str, default='generated.png')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device to run on ('cuda', 'cuda:1', 'cpu')")
    return parser


def main(argv=None) -> FeatureExtractor:
    """Run the CLI; returns the extractor, whose
    ``get_background_extraction()`` holds the kept features."""
    args = build_parser().parse_args(argv)
    layer = resolve_layer_config(args.layer)
    df = FeatureExtractor(layer, args.version, device=args.device, img_size=args.img_size,
                          dtype=args.dtype, weights=args.weights,
                          weights_variant=args.weights_variant, validate_layers=False)
    # the default layers are SD-1.5's: ids this version lacks are dropped
    # with a warning, as the reference drops them (silently)
    missing = sorted(set(TapSpec.from_config(layer).ids) - declared_ids(df.unet))
    if missing:
        print(f'warning: {args.version!r} has no layer {", ".join(missing)}; not extracted',
              file=sys.stderr)
    # which denoiser-call encounters to keep (reference :33)
    df.set_background_extraction(args.store_steps)

    prompts = df.encode_prompt(args.prompt)
    images, _ = df.sample(prompts, batch_size=1, num_inference_steps=args.steps,
                          guidance_scale=args.guidance_scale)

    from PIL import Image
    arr = images[0].float().cpu().numpy().transpose(1, 2, 0) * 255
    Image.fromarray(arr.astype(np.uint8)).save(args.output)
    print(f'saved {args.output}')

    # reference :42-48: the kept features per layer and step
    for layer, by_step in df.get_background_extraction().items():
        for step, feat in sorted(by_step.items()):
            print(layer, f'step={step}', tuple(feat.shape))
    return df


if __name__ == '__main__':
    main()
