"""Export a deployment bundle (``io/bundle.py``) from a diffusers
checkpoint, the port's counterpart of the JAX package's
``tools/make_bundle.py``: the one-time load (key matching, int8
quantization, a LoRA merge) whose result ``FeatureExtractor(weights=<bundle>)``
then warm-starts from.

    python -m diffusion_feature_tpu_torch.make_bundle --version flux \\
        --weights /ckpts/flux-dev --out /srv/flux-dev.bundle [--dtype bfloat16] \\
        [--no_transformer_8bit] [--no_t5_8bit] \\
        [--offline_lora DIR [--offline_lora_filename F]] [--device cuda]

The JAX flags, plus ``--device`` (default ``cuda``; ``cpu`` loads on the
host).
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--version', required=True)
    ap.add_argument('--weights', required=True, help='diffusers-format checkpoint dir')
    ap.add_argument('--out', required=True, help='bundle output dir')
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--img_size', type=int, default=1024,
                    help='the extractor\'s image size; the weights do not depend on it')
    ap.add_argument('--no_transformer_8bit', action='store_true',
                    help='keep the flux transformer full precision (default: int8 weight-only '
                         'for flux, as the facade loads it)')
    ap.add_argument('--no_t5_8bit', action='store_true',
                    help='keep the T5 encoder full precision (default: int8 for flux); the '
                         'manifest records the setting and a load with default flags takes it')
    ap.add_argument('--offline_lora', default=None,
                    help='merge this LoRA into the exported weights')
    ap.add_argument('--offline_lora_filename', default=None)
    ap.add_argument('--device', default='cuda')
    return ap


def main(argv=None) -> str:
    """Build the extractor from ``--weights`` and write its bundle to
    ``--out``; returns the bundle dir."""
    args = build_parser().parse_args(argv)
    from .facade import FeatureExtractor
    t0 = time.perf_counter()
    fe = FeatureExtractor(
        None, args.version, device=args.device, dtype=args.dtype, img_size=args.img_size,
        weights=args.weights, offline_lora=args.offline_lora,
        offline_lora_filename=args.offline_lora_filename,
        transformer_8bit=False if args.no_transformer_8bit else None,
        t5_8bit=False if args.no_t5_8bit else None, validate_layers=False)
    t1 = time.perf_counter()
    out = fe.save_converted(args.out)
    t2 = time.perf_counter()
    print(f'converted in {t1 - t0:.1f}s, exported to {out} in {t2 - t1:.1f}s')
    return out


if __name__ == '__main__':
    main()
