#!/usr/bin/env python3
"""Where one extract of the PyTorch port spends its time on the card.

    python3 tools/torch_extract_profile.py

For each of the paths ``chip_smoke.py`` drives (``chip_smoke.PATHS``),
after ``chip_smoke.extract_times``'s three warm-up calls: the median host
time to enqueue one extract and the median time between CUDA events around
it over ``chip_smoke.TIMED_CALLS`` calls, then one extract under
``torch.profiler`` with the device kernels summed by kind (flash and
head-mean kernels, matrix products, convolutions and their layout
transposes, normalisations, resizes, the rest, with the rest's largest
kernels by name).  Prints one JSON line per path.
"""

import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

KINDS = [  # first match wins
    ('flash (B1/B2)', r'flash_fwd'),
    ('head-mean (B3)', r'headmean'),
    ('groupnorm', r'RowwiseMoments|group_norm|GroupNorm'),
    ('layernorm', r'layer_norm|LayerNorm'),
    ('conv', r'conv|cudnn|implicit_convolve|fprop|dgrad|wgrad'),
    ('layout transpose', r'nchwToNhwc|nhwcToNchw|transpose'),
    ('matmul', r'gemm|cutlass|xmma|cublas|nvjet|Kernel2'),
    ('softmax', r'softmax'),
    ('resize', r'upsample|interpolate|bilinear'),
]


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return 'elementwise/other'


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    fa.build()
    card = chip_smoke.card_line()
    for name in chip_smoke.PATHS:
        fe, prompts, images = chip_smoke.open_path(torch, name)
        host, device = chip_smoke.extract_times(torch, fe, prompts, images,
                                                chip_smoke.TIMED_CALLS)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            chip_smoke.extract(fe, prompts, images)
            torch.cuda.synchronize()
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
            'device_span_ms': span_us / 1e3,
            'by_kind_ms_count': {k: [round(v[0], 3), v[1]] for k, v in
                                 sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
            'top_other_ms': {k: round(v, 3) for k, v in
                             sorted(other.items(), key=lambda kv: -kv[1])[:8]},
        }), flush=True)
        del fe
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
