#!/usr/bin/env python3
"""Time one path of the PyTorch port for one checkout of the repository.

    python3 tools/torch_extract_ab.py ROOT [--path xl|sd15_store|xl_store]
    python3 tools/torch_extract_ab.py ROOT --kernels [--width D]

Imports ``diffusion_feature_tpu_torch`` from ROOT, builds its kernels, and
times one of ``chip_smoke.PATHS`` (default ``xl``: SDXL ``xl-practical`` at
1024^2, batch 2, t=50, random weights) with ``chip_smoke.extract_times``:
15 calls between CUDA events after three warm-up calls.  The path's
settings come from this repository's ``chip_smoke.py``, whatever ROOT is.
Prints one JSON line with the median, quartiles, min and max in ms and the
card.  To compare two checkouts on one card, run it for both in turns in
one command (A B B A), e.g. with the parent unpacked by ``git archive``
into a directory ``.gitignore`` lists.

With ``--kernels`` it times, instead of a path, ROOT's B1 to B4 wrappers
(``flash_attention``, ``flash_attention_with_lse``, ``headmean_probs`` on
B2's logsumexp, ``short_attention``) on contiguous bf16 inputs (which every
checkout's wrappers take) at the shapes phase 2 of ``chip_smoke.py`` gives
them (``B1_SHAPES``, the CLI's trailing batch of 1, ``STORE_SHAPES``,
``SHORT_SHAPES``): in a loop of separate calls (``loop_ms``:
``chip_smoke.time_ms``, the median of three loops), which at the small
shapes times the host's cost per call as well as the kernel, and as CUDA
graphs of 20 calls (``graph_ms``: ``chip_smoke.graph_ms``, device time).
``--width D`` keeps the shapes of head width D only.  The JSON line also
carries ROOT's ``ptxas`` report (registers and spills) of every kernel
instance at those widths, from the build, when this call compiled it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CALLS = 15


def kernel_times(torch, fa, width=None) -> tuple:
    """({'<wrapper> (B,H,Sq,Sk,D)': ms per call in a loop of calls},
    {the same: ms per call in CUDA graphs}), at head width ``width`` only
    where given."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    cli = [(1,) + shape[1:] for shape in chip_smoke.B1_SHAPES[:3]]
    loop, graph = {}, {}
    for name, shapes in (('flash_attention', chip_smoke.B1_SHAPES + cli),
                         ('flash_attention_with_lse', chip_smoke.STORE_SHAPES),
                         ('headmean_probs', chip_smoke.STORE_SHAPES),
                         ('short_attention', chip_smoke.SHORT_SHAPES)):
        wrapper = getattr(fa, name)
        for b, h, sq, sk, d in shapes:
            if width is not None and d != width:
                continue
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device='cuda').to(torch.bfloat16)
                       for s in (sq, sk, sk))
            scale = d ** -0.5
            if name == 'headmean_probs':
                v = fa.flash_attention_with_lse(q, k, v, scale=scale)[1]   # its lse
            call = lambda: wrapper(q, k, v, scale=scale)                  # noqa: E731
            key = f'{name} {(b, h, sq, sk, d)}'
            loop[key] = chip_smoke.time_ms(torch, call, runs=3)
            graph[key] = chip_smoke.graph_ms(torch, call)
    return loop, graph


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('root')
    ap.add_argument('--path', choices=list(chip_smoke.PATHS), default='xl')
    ap.add_argument('--kernels', action='store_true')
    ap.add_argument('--width', type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    log = fa.build()['log']
    if args.kernels:
        loop, graph = kernel_times(torch, fa, args.width)
        tag = None if args.width is None else f'Li{args.width}E'
        ptxas = [line for line in chip_smoke.ptxas_summary(log) if tag is None or tag in line]
        print(json.dumps({'root': args.root, 'loop_ms': loop, 'graph_ms': graph, 'ptxas': ptxas,
                          'card': chip_smoke.card_line()}))
        return 0
    fe, prompts, images = chip_smoke.open_path(torch, args.path)
    _, times = chip_smoke.extract_times(torch, fe, prompts, images, CALLS,
                                        **chip_smoke.PATHS[args.path].get('extract', {}))
    n = len(times)
    print(json.dumps({'root': args.root, 'path': args.path, 'calls': n,
                      'median_ms': times[n // 2], 'q1_ms': times[n // 4],
                      'q3_ms': times[(3 * n) // 4], 'min_ms': times[0], 'max_ms': times[-1],
                      'card': chip_smoke.card_line()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
