#!/usr/bin/env python3
"""Where one extract (or one sample) of the PyTorch port spends its time on
the card.

    python3 tools/torch_extract_profile.py [NAME ...]

For each of the paths ``chip_smoke.py`` drives (``chip_smoke.PATHS``: the
U-Net paths of phases 3 to 11, the DiTs' of phases 14 to 16 and IF's of
phase 17),
after ``chip_smoke.extract_times``'s three warm-up calls: the median host
time to enqueue one extract and the median time between CUDA events around
it over ``chip_smoke.TIMED_CALLS`` calls, then one extract under
``torch.profiler`` with the device kernels summed by kind (flash and
head-mean kernels, matrix products, convolutions and their layout
transposes, normalisations, resizes, the rest, with the rest's largest
kernels by name).  The same for chip_smoke's generation and ControlNet
paths: ``sd15-gen`` (the generate_with_extraction defaults), ``xl-gen``
(phase 12b's sample) and ``if-gen`` (phase 17e's: IF at 64^2, 50 DDPM
steps, CFG) after one warm-up sample, over 3 samples;
``sd15-control`` (phase 13's extract, from a random tree written to a
temporary dir); and one training step of phase 19's paths, after two
warm-up steps, over 5 steps: ``seg-sdxl`` (seg_configs/ade_sdxl.json) and
``seg-vpd`` (ade_vpd.json, prompt tuning) through
``train_segmentation.train_step`` on a batch of 2 random 512^2 crops and
labels made on the device (the trainer's host decoding and augmentation
are not in it), ``train-unet`` (phase 19d's forward and backward); these
run with TF32 off, as chip_smoke.py, and ``seg-sdxl-tf32`` is
``seg-sdxl`` with cuDNN's default TF32 convolutions.  NAMEs pick paths (default: all).  Prints one JSON line
per path, with the profiled call's peak memory above what was allocated
before it.  Convolutions run as PyTorch sets them by default (cuDNN may
use TF32), unlike chip_smoke.py, which turns TF32 off.
"""

import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

KINDS = [  # first match wins
    ('flash backward', r'dkdv_kernel|dq_kernel|delta_kernel'),
    ('flash (B1/B2)', r'flash_fwd'),
    ('head-mean (B3)', r'headmean'),
    ('groupnorm', r'RowwiseMoments|group_norm|GroupNorm'),
    ('layernorm', r'layer_norm|LayerNorm'),
    ('conv', r'conv|cudnn|implicit_convolve|fprop|dgrad|wgrad'),
    ('layout transpose', r'nchwToNhwc|nhwcToNchw|transpose'),
    ('matmul', r'gemm|cutlass|xmma|cublas|nvjet|Kernel2'),
    ('softmax', r'softmax'),
    ('resize', r'upsample|interpolate|bilinear'),
    ('sort', r'sort'),
    ('optimizer', r'multi_tensor|adam'),
]


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return 'elementwise/other'


OTHER_PATHS = ('sd15-gen', 'xl-gen', 'if-gen', 'sd15-control')
TRAIN_PATHS = {'seg-sdxl': chip_smoke.SEG_CONFIG, 'seg-vpd': chip_smoke.VPD_CONFIG,
               'train-unet': None, 'seg-sdxl-tf32': chip_smoke.SEG_CONFIG}


def timed_runs(torch, run, warm, calls):
    """``warm`` untimed calls of ``run``, then ``calls`` timed: sorted host
    enqueue ms and sorted ms between CUDA events."""
    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(calls):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device.append(start.elapsed_time(stop))
    return sorted(host), sorted(device)


def open_training(torch, name):
    """(model, one training step, host ms, device ms) of phase 19's paths."""
    from diffusion_feature_tpu_torch import FeatureExtractor, train_segmentation
    gen = torch.Generator(device='cuda').manual_seed(4)
    if name == 'train-unet':
        fe = FeatureExtractor(chip_smoke.TRAIN_UNET_TAPS, '1-5', device='cuda', dtype='float32',
                              img_size=512, train_unet=True, seed=0)
        prompts = fe.encode_prompt('a photo of a cat')
        images = torch.rand(2, 3, 512, 512, generator=gen, device='cuda') * 2 - 1

        def run():
            fe.unet.zero_grad(set_to_none=True)
            feats = fe.extract(prompts, 2, images, image_type='tensor', t=50)
            sum((v.float() ** 2).mean() for v in feats.values()).backward()
        return (fe, run, *timed_runs(torch, run, 2, 5))
    with open(TRAIN_PATHS[name]) as f:
        cfg = json.load(f)
    seg = train_segmentation.segmentor_from_config(cfg, device='cuda')
    opt, sched = train_segmentation.make_optimizer(seg.init_state().values(), 1.6e-4, 1e-3,
                                                   80000)
    crop = cfg['crop_size'][0]
    images = torch.rand(2, 3, crop, crop, generator=gen, device='cuda') * 2 - 1
    labels = torch.randint(0, cfg['num_classes'], (2, crop, crop), generator=gen,
                           device='cuda')

    def run():
        train_segmentation.train_step(seg, opt, sched, images, labels, gen)
    return (seg, run, *timed_runs(torch, run, 2, 5))


def open_extract(torch, name):
    """(extractor, one extract, host ms, device ms) of a chip_smoke path."""
    fe, prompts, images = chip_smoke.open_path(torch, name)
    kwargs = chip_smoke.PATHS[name].get('extract', {})
    host, device = chip_smoke.extract_times(torch, fe, prompts, images, chip_smoke.TIMED_CALLS,
                                            **kwargs)
    return fe, lambda: chip_smoke.extract(fe, prompts, images, **kwargs), host, device


def open_other(torch, name, tmp):
    """The same for the generation and ControlNet paths; ``tmp`` holds the
    ControlNet path's tree."""
    from diffusion_feature_tpu_torch import FeatureExtractor, generate_with_extraction
    args = generate_with_extraction.build_parser().parse_args([])
    if name == 'sd15-control':
        src = FeatureExtractor(args.layer, args.version, img_size=args.img_size, seed=0)
        chip_smoke.write_control_tree(torch, src, tmp)
        del src
        fe = FeatureExtractor(**chip_smoke.CONTROL_ARGS, weights=tmp, seed=0,
                              control=list(chip_smoke.CONTROL_KINDS))
        prompts = fe.encode_prompt('a photo of a cat')
        size = fe.img_size
        images = torch.rand(2, 3, size, size, generator=torch.Generator(device='cuda')
                            .manual_seed(1), device='cuda') * 2 - 1
        host, device = chip_smoke.extract_times(torch, fe, prompts, images, chip_smoke.TIMED_CALLS,
                                                use_control=True)
        return (fe, lambda: chip_smoke.extract(fe, prompts, images, use_control=True), host,
                device)
    step_noise = None
    if name == 'sd15-gen':
        fe = FeatureExtractor(args.layer, args.version, img_size=args.img_size, seed=0)
        steps, guidance = args.steps, args.guidance_scale
    elif name == 'if-gen':
        if_args = generate_with_extraction.build_parser().parse_args(chip_smoke.IF_GEN_ARGS)
        fe = FeatureExtractor(**chip_smoke.PATHS['if']['args'], seed=0)
        steps, guidance = if_args.steps, if_args.guidance_scale
    else:
        fe = FeatureExtractor(**chip_smoke.XL_SAMPLE, seed=0)
        steps, guidance = chip_smoke.XL_SAMPLE_STEPS, chip_smoke.XL_GUIDANCE
    prompts = fe.encode_prompt(args.prompt)
    gen = torch.Generator(device='cuda').manual_seed(7)
    noise = torch.randn(fe.latent_shape(1), generator=gen, device='cuda')
    if name == 'if-gen':   # DDPM: one draw per step
        step_noise = [torch.randn(fe.latent_shape(1), generator=gen, device='cuda')
                      for _ in range(steps)]

    conds = fe._sample_conditioning(prompts, 1, guidance)

    def run():
        return fe._sample(*conds, noise, steps, guidance, step_noise)
    run()
    host, device = [], []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device.append(start.elapsed_time(stop))
    return fe, run, sorted(host), sorted(device)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    fa.build()
    card = chip_smoke.card_line()
    names = sys.argv[1:] or [*chip_smoke.PATHS, *OTHER_PATHS, *TRAIN_PATHS]
    for name in names:
        # phase 19's fp32 training paths as chip_smoke.py runs them
        torch.backends.cudnn.allow_tf32 = name not in TRAIN_PATHS or name.endswith('-tf32')
        with tempfile.TemporaryDirectory() as tmp:
            fe, run, host, device = (open_other(torch, name, tmp) if name in OTHER_PATHS
                                     else open_training(torch, name) if name in TRAIN_PATHS
                                     else open_extract(torch, name))
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.profiler.profile(activities=acts) as prof:
                run()
                torch.cuda.synchronize()
            peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kind, other, busy_us = {}, {}, 0.0
        for e in kernels:
            us = e.time_range.elapsed_us()
            busy_us += us
            kind = kind_of(e.name)
            k = by_kind.setdefault(kind, [0.0, 0])
            k[0] += us / 1e3
            k[1] += 1
            if kind == 'elementwise/other':
                other[e.name[:80]] = other.get(e.name[:80], 0.0) + us / 1e3
        span_us = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
                   if kernels else 0.0)
        print(json.dumps({
            'config': name, 'card': card,
            'host_enqueue_ms_median': host[len(host) // 2],
            'extract_ms_median': device[len(device) // 2],
            'profiled_kernels': len(kernels), 'device_busy_ms': busy_us / 1e3,
            'device_span_ms': span_us / 1e3, 'peak_gib_above_held': peak_gib,
            'by_kind_ms_count': {k: [round(v[0], 3), v[1]] for k, v in
                                 sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
            'top_other_ms': {k: round(v, 3) for k, v in
                             sorted(other.items(), key=lambda kv: -kv[1])[:8]},
        }), flush=True)
        del fe, run   # the call holds the extractor too (Flux's is ~34 GB)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
