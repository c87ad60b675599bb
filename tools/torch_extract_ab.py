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

``--kernels`` also times what the training paths run: the backward
(``flash_attention_bwd``, on B2's output and logsumexp) at ``BWD_SHAPES``
in each shape's dtype, and fp32 B1 and B2 at the shapes ``ade_vpd`` and
``train_unet`` hand them and SD-2.1's fp32 store shape (``FP32_SHAPES``),
all on head-split views as the paths give them.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CALLS = 15
#: fp32 B1/B2 (wrapper, shape): ade_vpd's and train_unet's SD-1.5 levels 0
#: and 1 at 512^2, SD-2.1's upcast store at 512^2
FP32_SHAPES = [('flash_attention', (2, 8, 4096, 4096, 40)),
               ('flash_attention_with_lse', (2, 8, 4096, 4096, 40)),
               ('flash_attention_with_lse', (2, 8, 1024, 1024, 80)),
               ('flash_attention_with_lse', (2, 10, 1024, 1024, 64))]


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


def split_inputs(torch, gen, shape, dtype, n):
    """n head-split (B, H, S, D) views of (B, S, H*D) tensors: the first
    with Sq rows (q, or with n = 1 an output gradient), the others with Sk."""
    b, h, sq, sk, d = shape
    lens = [sq] + [sk] * (n - 1)
    return [torch.randn(b, s, h * d, generator=gen, device='cuda').to(dtype)
            .reshape(b, s, h, d).transpose(1, 2) for s in lens]


def train_times(torch, fa, width=None) -> tuple:
    """({'<wrapper> <dtype> (B,H,Sq,Sk,D)': ms per call in a loop of calls},
    {the same in CUDA graphs}) for the backward at ``BWD_SHAPES`` and fp32
    B1/B2 at ``FP32_SHAPES``."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    loop, graph = {}, {}
    cases = [('flash_attention_bwd', s, dt) for s, dt in chip_smoke.BWD_SHAPES]
    cases += [(name, s, 'float32') for name, s in FP32_SHAPES]
    for name, shape, dt in cases:
        if width is not None and shape[-1] != width:
            continue
        dtype = getattr(torch, dt)
        scale = shape[-1] ** -0.5
        q, k, v = split_inputs(torch, gen, shape, dtype, 3)
        if name == 'flash_attention_bwd':
            grad = split_inputs(torch, gen, shape, dtype, 1)[0]
            out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale)
            call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, grad,  # noqa: E731
                                                  scale=scale)
        else:
            wrapper = getattr(fa, name)
            call = lambda: wrapper(q, k, v, scale=scale)                  # noqa: E731
        key = f'{name} {dt} {shape}'
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
        train_loop, train_graph = train_times(torch, fa, args.width)
        loop.update(train_loop)
        graph.update(train_graph)
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
