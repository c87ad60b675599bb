#!/usr/bin/env python3
"""Time one path of the PyTorch port for one checkout of the repository.

    python3 tools/torch_extract_ab.py ROOT [--path NAME]
    python3 tools/torch_extract_ab.py ROOT --kernels [--width D,..] [--dtype NAME] [--only NAME,..]
    python3 tools/torch_extract_ab.py ROOT --int8_routes

Imports ``diffusion_feature_tpu_torch`` from ROOT, builds its kernels, and
times one of ``chip_smoke.PATHS`` (default ``xl``: SDXL ``xl-practical`` at
1024^2, batch 2, t=50, random weights) with ``chip_smoke.extract_times``:
15 calls between CUDA events after two warm-up calls, or with a name of
``SAMPLE_PATHS`` a generation sample (``chip_smoke.timed_sample``:
``fe._sample`` between CUDA events, three timed after one untimed; e.g.
``flux_gen``, phase 16e's Flux.1-dev sample at 512^2, 28 steps, guidance
3.5, batch 1).  The path's settings come from this repository's
``chip_smoke.py``, whatever ROOT is.
Prints one JSON line with the median, quartiles, min and max in ms and the
card.  To compare two checkouts on one card, run it for both in turns in
one command (A B B A), e.g. with the parent unpacked by ``git archive``
into a directory ``.gitignore`` lists.

With ``--kernels`` it times, instead of a path, ROOT's B1 to B4 wrappers
(``flash_attention``, ``flash_attention_with_lse``, ``headmean_probs`` on
B2's logsumexp, ``short_attention``) on contiguous bf16 inputs (which every
checkout's wrappers take) at the shapes phase 2 of ``chip_smoke.py`` gives
them (``B1_SHAPES``, the CLIs' trailing batch of 1, Flux's joint
attention ``FLUX_B1_SHAPES`` and the mesh's head and token shards of
phase 22, ``STORE_SHAPES``, ``SHORT_SHAPES``): in a loop of separate calls (``loop_ms``:
``chip_smoke.time_ms``, the median of three loops), which at the small
shapes times the host's cost per call as well as the kernel, and as CUDA
graphs of 20 calls (``graph_ms``: ``chip_smoke.graph_ms``, device time).
``--width D[,D...]`` keeps the shapes of those head widths only, ``--dtype NAME``
(``bfloat16``, ``float16`` or ``float32``) the cases of that dtype.  The
JSON line also carries ROOT's ``ptxas`` report (registers and spills) of
every kernel instance at those widths, from the build, when this call
compiled it.

``--kernels`` also times W8A16 (``quant.int8_linear``) in bf16 at every
shape of ``chip_smoke.int8_phase2_shapes()`` (loops and graphs), and the
JSON line carries the graph times summed over the launches of one int8
Flux extract at 1024^2, batch 2 (``int8_per_extract_ms``: 495 launches) and
of its ``encode_prompt`` (``int8_per_prompt_ms``: 168).  ``--only NAME[,NAME...]``
keeps the cases of those wrappers (``int8_linear``, ``flash_attention``,
...).

``--int8_routes`` (ROOT with ``quant.ROUTES``) checks and times every
W8A16 kernel of ROOT's bf16 library on its own, the entry point called with
each route a shape can take, at the phase-2 shapes and at ``ROUTE_SWEEP``
(the rows where the streaming and the TMA kernels meet, and where the
256-row tile starts to fill a wave): per shape and route the worst
error against the twin (and whether it is bit for bit the twin's), the
graph time, the share of the bound, and ``F.linear`` on the dequantized
weight beside them, one JSON line each (long output: send it to a
file).

``--kernels`` also times what the training paths run: the backward
(``flash_attention_bwd``, on B2's output and logsumexp) at ``BWD_SHAPES``
in each shape's dtype, and the fp32 kernels (``FP32_SHAPES``): B1 and B2
at the shapes ``ade_vpd`` and ``train_unet`` hand them and SD-2.1's fp32
store shape, B3 at ``STORE_SHAPES`` and that store shape, all on head-split
views as the paths give them, and B4 at ``SHORT_SHAPES`` on contiguous
inputs (phase 2's layout for it: no path launches B4).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CALLS = 15
SAMPLES = 3
#: generation samples --path times (phase 16e's: the generation CLI's
#: version, size, taps, steps and guidance, batch 1, noise from seed 7)
SAMPLE_PATHS = {'flux_gen': dict(layer=chip_smoke.FLUX_TAPS, version='flux', img_size=512,
                                 steps=28, guidance=3.5)}
#: --int8_routes: (M, K, N) beyond the phase-2 shapes, bf16, with a bias: M
#: around the streaming kernel's limit at the adaLN widths, and M where the
#: TMA kernel's 256-row tiles start to fill the card at Flux's and T5's widths
ROUTE_SWEEP = [(m, 3072, n) for n in (9216, 18432) for m in (1, 4, 8, 12, 16, 17, 24, 32, 64)]
ROUTE_SWEEP += [(m, 3072, 3072) for m in (128, 512, 1280, 1408, 2048, 4096)]
ROUTE_SWEEP += [(m, 4096, 4096) for m in (1024, 1536, 2048)]
#: the fp32 kernels (wrapper, shape): B1/B2 at ade_vpd's and train_unet's
#: SD-1.5 levels 0 and 1 at 512^2 and SD-2.1's upcast store at 512^2, B3 at
#: phase 2's store shapes and that store shape, B4 at phase 2's short shapes
FP32_SHAPES = [('flash_attention', (2, 8, 4096, 4096, 40)),
               ('flash_attention_with_lse', (2, 8, 4096, 4096, 40)),
               ('flash_attention_with_lse', (2, 8, 1024, 1024, 80)),
               ('flash_attention_with_lse', (2, 10, 1024, 1024, 64)),
               *(('headmean_probs', s) for s in chip_smoke.STORE_SHAPES
                 + chip_smoke.FP32_STORE_SHAPES),
               *(('short_attention', s) for s in chip_smoke.SHORT_SHAPES)]


def int8_times(torch, loop, graph) -> dict:
    """W8A16 through ``quant.int8_linear`` at every phase-2 shape in bf16,
    into ``loop`` and ``graph``; returns the graph times summed over one
    int8 Flux extract's and one encode_prompt's launches."""
    from diffusion_feature_tpu_torch.models.registry import get_model_spec
    from diffusion_feature_tpu_torch.ops import quant
    gen = torch.Generator(device='cuda').manual_seed(0)
    by_shape = {}
    for shape, bias in chip_smoke.int8_phase2_shapes():
        x, q, scale, b = chip_smoke.int8_inputs(torch, gen, shape, torch.bfloat16, bias)
        call = lambda: quant.int8_linear(x, q, scale, b)                  # noqa: E731
        key = f'int8_linear {shape}{" +bias" if bias else ""}'
        loop[key] = chip_smoke.time_ms(torch, call, runs=3)
        graph[key] = by_shape[shape] = chip_smoke.graph_ms(torch, call)
        del x, q, scale, b
    spec = get_model_spec('flux')
    vae_scale = 2 ** (len(spec.vae.block_out_channels) - 1)
    extract = chip_smoke.flux_int8_calls(spec, 1024, 2, vae_scale)
    prompt = chip_smoke.t5_int8_calls(spec.t5, spec.prompt_max_length)
    return {'int8_per_extract_ms': sum(c * by_shape[s] for s, c in extract.items()),
            'int8_per_extract_launches': sum(extract.values()),
            'int8_per_prompt_ms': sum(c * by_shape[s] for s, c in prompt.items()),
            'int8_per_prompt_launches': sum(prompt.values())}


def int8_route_times(torch, fa) -> list:
    """Prints one JSON line per (shape, route) of ``--int8_routes``: every
    W8A16 kernel of ROOT's bf16 library called through its entry point with
    that route, against the twin and timed (graphs), beside F.linear on the
    dequantized weight; a route whose launch fails is recorded with its
    error.  Returns the records."""
    from diffusion_feature_tpu_torch.ops import quant
    F = torch.nn.functional
    gen = torch.Generator(device='cuda').manual_seed(0)
    lib = fa._lib('w8a16', torch.bfloat16)
    tol = chip_smoke.TOL['bfloat16']
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = chip_smoke.int8_phase2_shapes() + [(s, True) for s in ROUTE_SWEEP]
    records = []
    for shape, bias in cases:
        m, k, n = shape
        x, q, scale, b = chip_smoke.int8_inputs(torch, gen, shape, torch.bfloat16, bias)
        ref = quant.int8_linear_reference(x, q, scale, b)
        chosen = quant.int8_route(m, n, k, torch.bfloat16, True, sms)
        w = quant.dequantize_int8(q, scale, torch.bfloat16)
        matmul_ms = chip_smoke.graph_ms(torch, lambda: F.linear(x, w, b))
        del w
        bound_ms, bound_by = chip_smoke.int8_bound(shape, 'bfloat16', bias)
        routes = [0, 1, 2] + ([3] if m <= quant.STREAM_MAX_ROWS else [])
        for route in routes:
            out = torch.empty(m, n, dtype=torch.bfloat16, device='cuda')
            run = lambda: lib.dft_w8a16_linear(  # noqa: E731
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), None if b is None else b.data_ptr(),
                out.data_ptr(), m, n, k, fa._DTYPE_CODES[torch.bfloat16], route, fa._stream(x))
            rec = {'shape': shape, 'bias': bias, 'route': quant.ROUTES[route],
                   'chosen': route == chosen}
            err = run()
            torch.cuda.synchronize()
            if err:
                rec['error'] = err
            else:
                worst, ratio = chip_smoke.worst_ratio(torch, out, ref, tol, tol)
                ratio, _ = chip_smoke.rel_l2_ratio(torch, out, ref, tol, ratio)
                ms = chip_smoke.graph_ms(torch, run)
                rec.update(max_abs_err=worst, worst_over_allowed=ratio,
                           bit_equal=bool(torch.equal(out, ref)), ms=ms, matmul_ms=matmul_ms,
                           bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del x, q, scale, b, ref
    return records


def kernel_times(torch, fa, width=None, dtype_name=None, only=None) -> tuple:
    """({'<wrapper> (B,H,Sq,Sk,D)': ms per call in a loop of calls},
    {the same: ms per call in CUDA graphs}) in bf16, at the head widths in
    ``width`` only where given, of the wrappers in ``only`` only where given; nothing where
    ``dtype_name`` names another dtype."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    # the CLIs' trailing batch of 1: SDXL's, PixArt-Sigma's and HunyuanDiT's
    cli = [(1,) + shape[1:] for shape in chip_smoke.B1_SHAPES[:3] + [
        s for s in chip_smoke.B1_SHAPES if s[-1] in (72, 88) and s[2] == 4096]]
    loop, graph = {}, {}
    if dtype_name not in (None, 'bfloat16'):
        return loop, graph
    flux = (chip_smoke.FLUX_B1_SHAPES + chip_smoke.TP_FLUX_B1_SHAPES
            + chip_smoke.SP_FLUX_B1_SHAPES + chip_smoke.TP_B1_SHAPES + chip_smoke.SP_B1_SHAPES)
    for name, shapes in (('flash_attention', chip_smoke.B1_SHAPES + cli + flux),
                         ('flash_attention_with_lse', chip_smoke.STORE_SHAPES),
                         ('headmean_probs', chip_smoke.STORE_SHAPES),
                         ('short_attention', chip_smoke.SHORT_SHAPES)):
        if only is not None and name not in only:
            continue
        wrapper = getattr(fa, name)
        for b, h, sq, sk, d in shapes:
            if width is not None and d not in width:
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


def train_times(torch, fa, width=None, dtype_name=None, only=None) -> tuple:
    """({'<wrapper> <dtype> (B,H,Sq,Sk,D)': ms per call in a loop of calls},
    {the same in CUDA graphs}) for the backward at ``BWD_SHAPES`` and the
    fp32 kernels at ``FP32_SHAPES`` (of the wrappers in ``only`` where given)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    loop, graph = {}, {}
    cases = [('flash_attention_bwd', s, dt) for s, dt in chip_smoke.BWD_SHAPES]
    cases += [(name, s, 'float32') for name, s in FP32_SHAPES]
    for name, shape, dt in cases:
        if ((width is not None and shape[-1] not in width) or dtype_name not in (None, dt)
                or (only is not None and name not in only)):
            continue
        dtype = getattr(torch, dt)
        scale = shape[-1] ** -0.5
        if name == 'short_attention':
            b, h, sq, sk, d = shape
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device='cuda').to(dtype)
                       for s in (sq, sk, sk))
        else:
            q, k, v = split_inputs(torch, gen, shape, dtype, 3)
        if name == 'headmean_probs':
            v = fa.flash_attention_with_lse(q, k, v, scale=scale)[1]   # its lse
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


def sample_times(torch, name) -> list:
    """SAMPLES generation samples of SAMPLE_PATHS[name] after one untimed
    one, ms each, sorted."""
    from diffusion_feature_tpu_torch import FeatureExtractor
    cfg = dict(SAMPLE_PATHS[name])
    steps, guidance = cfg.pop('steps'), cfg.pop('guidance')
    fe = FeatureExtractor(**cfg, dtype='bfloat16', device='cuda', seed=0)
    prompts, step_noise = chip_smoke.sample_inputs(torch, fe, 'a photo of a cat', steps)
    latent = fe.img_size // fe.vae_scale
    noise = torch.randn((1, fe.spec.vae.latent_channels, latent, latent),
                        generator=torch.Generator(device='cuda').manual_seed(7), device='cuda')
    times = []
    for i in range(SAMPLES + 1):
        ms = chip_smoke.timed_sample(torch, fe, prompts, noise, steps, guidance, step_noise)[3]
        if i:
            times.append(ms)
    return sorted(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('root')
    ap.add_argument('--path', choices=list(chip_smoke.PATHS) + list(SAMPLE_PATHS), default='xl')
    ap.add_argument('--kernels', action='store_true')
    ap.add_argument('--width', type=lambda text: [int(w) for w in text.split(',')],
                    default=None)
    ap.add_argument('--dtype', choices=['bfloat16', 'float16', 'float32'], default=None)
    ap.add_argument('--only', type=lambda text: text.split(','), default=None)
    ap.add_argument('--int8_routes', action='store_true')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    log = fa.build()['log']
    if args.int8_routes:
        ptxas = [line for line in chip_smoke.ptxas_summary(log) if 'w8a16' in line]
        records = int8_route_times(torch, fa)
        print(json.dumps({'root': args.root, 'int8_route_records': len(records),
                          'failed': sum('error' in r for r in records), 'ptxas': ptxas,
                          'card': chip_smoke.card_line()}))
        return 0
    if args.kernels:
        loop, graph = kernel_times(torch, fa, args.width, args.dtype, args.only)
        train_loop, train_graph = train_times(torch, fa, args.width, args.dtype, args.only)
        loop.update(train_loop)
        graph.update(train_graph)
        sums = {}
        if args.width is None and args.dtype in (None, 'bfloat16') and (
                args.only is None or 'int8_linear' in args.only):
            sums = int8_times(torch, loop, graph)
        tags = None if args.width is None else [f'Li{w}E' for w in args.width]
        ptxas = [line for line in chip_smoke.ptxas_summary(log)
                 if tags is None or any(tag in line for tag in tags)]
        print(json.dumps({'root': args.root, 'loop_ms': loop, 'graph_ms': graph, **sums,
                          'ptxas': ptxas, 'card': chip_smoke.card_line()}))
        return 0
    if args.path in SAMPLE_PATHS:
        times = sample_times(torch, args.path)
    else:
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
