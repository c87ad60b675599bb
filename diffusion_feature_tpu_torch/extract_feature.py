"""Batch feature-extraction CLI of the PyTorch port:

    python -m diffusion_feature_tpu_torch.extract_feature --version xl \\
        --img_size 1024 --layer xl-practical --input_dir 'imgs/*.png' \\
        --prompt 'a photo' --output_dir out/

The flags, defaults, input naming, prompt handling and on-disk layouts of
the JAX package's ``extract_feature.py`` (the reference CLI's surface,
reference extract_feature.py:15-148), plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain twins).

Several devices: ``--dp/--tp/--sp`` above 1 take one process per rank,
``torchrun --nproc_per_node <dp*sp*tp> -m
diffusion_feature_tpu_torch.extract_feature --dp 2 ...`` (each process on
``cuda:<LOCAL_RANK>`` when ``--device cuda``; NCCL there, gloo on the
CPU), or processes that joined a group of the caller's backend before
calling ``main`` (gloo for ranks that share one card).  The
mesh is ``parallel.mesh.make_mesh(dp, tp, sp)`` of the launched group;
without one of dp*sp*tp ranks ``make_mesh`` raises ValueError.
``--batch_size`` rounds up to a multiple of dp, as in the JAX CLI.  Under
dp each rank reads and writes only its rows of each batch (the dumps are
never gathered, and name each image as the one-device run does); under
tp and sp the rank of tp and sp coordinate 0 in each dp row writes.

A trailing batch shorter than ``--batch_size`` runs at its own size: eager
PyTorch compiles nothing per shape, so the JAX CLI's padding of that batch
to the static batch size is dropped; the dumps hold only the real images,
as there.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from .configs import resolve_layer_config
from .enumerate_layers import enumerate_layers
from .facade import FeatureExtractor
from .io.dump import save_batch
from .io.prefetch import PrefetchLoader
from .native import AsyncDumpWriter
from .parallel.mesh import init_launched, make_mesh


def _strict_bool(s):
    v = s.strip().lower()
    if v in ('true', '1', 'yes'):
        return True
    if v in ('false', '0', 'no'):
        return False
    raise argparse.ArgumentTypeError(f'expected true/false, got {s!r}')


def build_parser():
    parser = argparse.ArgumentParser()
    # package settings (reference extract_feature.py:18-29)
    parser.add_argument('--layer', type=str, default=None,
                        help='layer config json: which activations to extract')
    parser.add_argument('--version', type=str, default='xl')
    parser.add_argument('--dtype', type=str, default='bfloat16',
                        choices=('float16', 'float32', 'bfloat16'))
    parser.add_argument('--offline_lora', type=str, default=None)
    parser.add_argument('--offline_lora_filename', type=str, default=None)
    parser.add_argument('--feature_resize', type=int, default=1)
    parser.add_argument('--control', type=str, nargs='+', default=None)
    parser.add_argument('--attention', type=str, nargs='+', default=None,
                        choices=('down_cross', 'mid_cross', 'up_cross',
                                 'down_self', 'mid_self', 'up_self'))
    parser.add_argument('--img_size', type=int, default=1024)
    # extraction settings
    parser.add_argument('--batch_size', '-b', type=int, default=2)
    parser.add_argument('--t', type=int, default=50)
    parser.add_argument('--denoising_from', type=int, default=None)
    parser.add_argument('--use_ddim_inversion', action='store_true')
    # io settings (reference :35-43)
    parser.add_argument('--input_dir', type=str, default=None,
                        help='glob pattern for input images')
    parser.add_argument('--nested_input_dir', action='store_true')
    parser.add_argument('--prompt_file', type=str, default='prompt.txt')
    parser.add_argument('--prompt', type=str, default=None,
                        help='inline prompt (alternative to --prompt_file)')
    parser.add_argument('--output_dir', type=str, default='./output/')
    parser.add_argument('--aggregate_output', action='store_true')
    parser.add_argument('--use_original_filename', action='store_true')
    parser.add_argument('--split', type=str, default='train')
    parser.add_argument('--sample_name_first', action='store_true')
    # weights; parallelism (one process per rank: torchrun)
    parser.add_argument('--weights', type=str, default=None,
                        help='local diffusers checkpoint dir (default: random init)')
    parser.add_argument('--weights_variant', type=str, default=None,
                        help="weight-set variant of a checkpoint dir ('fp16', 'bf16', 'main')")
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel ranks: each extracts and writes its rows of '
                             'every batch')
    parser.add_argument('--tp', type=int, default=1,
                        help="tensor-parallel ranks: the denoiser's projections are cut "
                             'over them')
    parser.add_argument('--sp', type=int, default=1,
                        help="sequence-parallel ranks: the DiTs' tokens are split over them "
                             '(pixart, hunyuan, flux; composes with --dp/--tp)')
    parser.add_argument('--transformer_8bit', type=_strict_bool,
                        default=None, metavar='{true,false}',
                        help='int8 weight-only flux transformer; default auto: on for flux '
                             'with --weights unless a LoRA merges')
    # debug / observability
    parser.add_argument('--show_all_layers', action='store_true')
    parser.add_argument('--no_validate_layers', action='store_true',
                        help='skip the unknown-layer-id check (restores the '
                             "reference's silent-drop behavior)")
    parser.add_argument('--profile', type=str, default=None, metavar='DIR',
                        help='write a torch.profiler trace of the extraction '
                             'loop to DIR/trace.json (chrome://tracing, Perfetto)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device to run on ('cuda', 'cuda:1', 'cpu')")
    return parser


def main(argv=None, group=None):
    """Run the CLI on ``argv``; ``group``: the process group of a
    ``--dp/--tp/--sp`` run's ranks (default: every launched rank)."""
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    print(f'Run folder: {args.output_dir}')

    if args.show_all_layers:
        # shapes only: the U-Net runs on the meta device, with no weights
        # (the reference needs a full real forward, extract_feature.py:102-110)
        layer_record = {}
        for k, shape in sorted(enumerate_layers(args.version, args.img_size).items()):
            print(k, tuple(shape[1:]))
            layer_record[k] = True
        with open('layer_record.json', 'w') as f:
            f.write(json.dumps(layer_record))
        return

    mesh = None
    if args.dp > 1 or args.tp > 1 or args.sp > 1:
        args.device = init_launched('gloo' if args.device == 'cpu' else 'nccl', args.device)
        mesh = make_mesh(dp=args.dp, tp=args.tp, sp=args.sp, group=group)
        if args.batch_size % args.dp:
            new_bs = -(-args.batch_size // args.dp) * args.dp
            print(f'note: --batch_size {args.batch_size} does not divide --dp {args.dp}; '
                  f'rounding up to {new_bs} so batches shard over dp', file=sys.stderr)
            args.batch_size = new_bs
    if args.device.startswith('cuda:'):
        import torch
        torch.cuda.set_device(args.device)

    df = FeatureExtractor(
        resolve_layer_config(args.layer),
        args.version,
        device=args.device,
        dtype=args.dtype,
        offline_lora=args.offline_lora,
        offline_lora_filename=args.offline_lora_filename,
        feature_resize=args.feature_resize,
        control=args.control,
        attention=args.attention,
        img_size=args.img_size,
        weights=args.weights,
        weights_variant=args.weights_variant,
        transformer_8bit=args.transformer_8bit,
        validate_layers=not args.no_validate_layers,
        mesh=mesh,
    )
    writes = mesh is None or mesh.writes

    # input list (reference :68-75)
    from PIL import Image
    imgs = sorted(glob.glob(args.input_dir, recursive=True))
    if not imgs:
        print(f'no images matched {args.input_dir!r}', file=sys.stderr)
        sys.exit(1)
    names = []
    for img in imgs:
        if not args.nested_input_dir:
            names.append(os.path.splitext(os.path.basename(img))[0])
        else:
            names.append(os.path.join(
                os.path.basename(os.path.split(img)[0]),
                os.path.splitext(os.path.basename(img))[0]))

    # prompt (reference :77-82)
    if args.prompt is not None:
        prompts_text = args.prompt
    else:
        with open(args.prompt_file) as f:
            prompts_text = f.read()
    print('prompt:', prompts_text)
    prompts = df.encode_prompt(prompts_text)

    writer = AsyncDumpWriter(n_threads=4)
    if writer.is_native:
        print('native async dump writer active')

    # double-buffered input pipeline: decode ahead of the device; under dp
    # each rank decodes only its rows of each batch
    batches = [list(range(i, min(i + args.batch_size, len(imgs))))
               for i in range(0, len(imgs), args.batch_size)]
    rows = [range(b[0] + lo, b[0] + hi) for b in batches for lo, hi in [df.dp_rows(len(b))]]
    loader = PrefetchLoader([imgs[j] for r in rows for j in r], [len(r) for r in rows],
                            lambda p: Image.open(p).convert('RGB'))

    profiler = None
    if args.profile:
        # host and device trace of the loop; best-effort, as where the
        # profiler's device tracing is unavailable
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if df.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        try:
            profiler = profile(activities=activities)
            profiler.start()
            print(f'profiling to {args.profile}')
        except RuntimeError as e:
            profiler = None
            print(f'profiler unavailable: {e}', file=sys.stderr)

    i, start, seconds = 0, None, None
    try:
        for batch, mine, (_, sublist) in zip(batches, rows, loader):
            if start is None:
                start = time.perf_counter()
            features = df.extract_rows(
                prompts, len(batch), sublist,
                t=args.t,
                denoising_from=args.denoising_from,
                use_control=args.control is not None,
                use_ddim_inversion=args.use_ddim_inversion,
            )
            if writes and sublist:
                save_batch(
                    features, args.output_dir,
                    batch_start_index=mine.start,
                    original_names=names[mine.start:mine.stop],
                    split=args.split,
                    use_original_filename=args.use_original_filename,
                    sample_name_first=args.sample_name_first,
                    aggregate_output=args.aggregate_output,
                    nested=args.nested_input_dir,
                    writer=writer,
                )
            i += len(batch)
            print(f'{i}/{len(imgs)}')
    finally:
        # dumps already submitted must land on disk, and the trace must
        # survive mid-loop failures
        writer.close()
        if start is not None:
            seconds = time.perf_counter() - start
        if profiler is not None:
            profiler.stop()
            os.makedirs(args.profile, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile, 'trace.json'))
            print(f'profile written to {args.profile}')
    print(f'{i} images in {seconds:.3f} s from the first batch to the writer close '
          f'({i / seconds:.3f} img/s)')


if __name__ == '__main__':
    main()
