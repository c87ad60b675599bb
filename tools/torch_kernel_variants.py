#!/usr/bin/env python3
"""Time compile-time variants of the DiT widths' attention kernels in one
process, on the card.

    python3 tools/torch_kernel_variants.py [--out FILE]

B1's ping-pong kernel (csrc/flash_hopper.cuh at d=72, 88, 128) is built as
it ships and as each variant of ``VARIANTS`` (a copy of csrc/ with one
``Cfg`` line replaced, compiled with its namespace renamed so that two
builds of the same kernels can share the process), and each build is
timed at Flux's, PixArt's and HunyuanDiT's phase-2 shapes as CUDA graphs
(``chip_smoke.graph_ms``), in two rounds, beside SDPA.  B3 at d=72 and 88 is
timed through its entry point with the lone kernel (clusters 0), the
cluster count ``headmean_clusters`` picks and the most clusters the card
holds at once, and its cluster kernel as built from each of
``B3_VARIANTS``: a shallower ring, and two ablations that compute a wrong
map on purpose to show what bounds it (no exponentials: the scores added
as they are; one of QK^T's five k-steps at d=72).  Prints one JSON line
per shape and the card.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

_BN = 'static constexpr int kBN = D == 128 ? 192 : (kPingPong || D <= 80 ? 128 : 64);'
_CLUSTER = 'static constexpr int kCluster = kPingPong ? 2 : 1;'
#: name -> (the Cfg line of flash_hopper.cuh, its replacement)
VARIANTS = {
    'no-cluster': (_CLUSTER, 'static constexpr int kCluster = 1;'),
    'd128-keys128': (_BN, 'static constexpr int kBN = kPingPong || D <= 80 ? 128 : 64;'),
    'd128-keys176': (_BN, 'static constexpr int kBN = D == 128 ? 176 : '
                          '(kPingPong || D <= 80 ? 128 : 64);'),
}
_EXP = 'acc[n * 4 + e] += fast_exp2(fmaf(sc[n * 4 + e], scale_log2, e < 2 ? m0 : m1));'
#: name -> [(a line of headmean_hopper.cuh, its replacement)], each applied
#: to every occurrence (the lone and the cluster kernel share these lines)
B3_VARIANTS = {
    'b3-two-stages': [('static constexpr int kStages = kAtoms == 1 ? 4 : (kAtoms == 2 ? 3 : 2);',
                       'static constexpr int kStages = kAtoms == 1 ? 4 : 2;')],
    'b3-no-exp': [(_EXP, 'acc[n * 4 + e] += fmaf(sc[n * 4 + e], scale_log2, e < 2 ? m0 : m1);')],
    'b3-one-kstep': [('for (int kk = 0; kk < C::kDP / 16; ++kk) {',
                      'for (int kk = 0; kk < 1; ++kk) {')],
}
B1_SHAPES = (chip_smoke.FLUX_B1_SHAPES + chip_smoke.TP_FLUX_B1_SHAPES
             + chip_smoke.SP_FLUX_B1_SHAPES
             + [s for s in chip_smoke.B1_SHAPES + chip_smoke.SP_B1_SHAPES if s[-1] in (72, 88)])
B3_SHAPES = [s for s in chip_smoke.STORE_SHAPES if s[-1] in (72, 88)] + [
    (2, 16, 2048, 2048, 72), (1, 16, 4096, 4096, 72), (2, 16, 1536, 1536, 72)]


def build_variant(fa, name, header, subs, source, root):
    """The bf16 library of ``source`` (``flash_bf16.cu`` or
    ``headmean_bf16.cu``) as variant ``name``: csrc/ copied under ``root``
    with each (line, replacement) of ``subs`` replaced in ``header``, the
    namespace dft renamed dft_<name>."""
    src = os.path.join(root, name)
    shutil.copytree(fa._CSRC, src)
    path = os.path.join(src, header)
    text = open(path).read()
    for line, replacement in subs:
        if line not in text:
            raise RuntimeError(f'{name}: {line!r} is not in {header}')
        text = text.replace(line, replacement)
    with open(path, 'w') as f:
        f.write(text)
    lib = os.path.join(src, 'lib.so')
    ns = 'dft_' + name.replace('-', '_')
    proc = subprocess.Popen([fa._nvcc(), *fa._NVCC_FLAGS, f'-Ddft={ns}', '-o', lib,
                             os.path.join(src, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def load(fa, path, names):
    lib = ctypes.CDLL(path)
    for fn in names:
        getattr(lib, fn).argtypes = fa._ARGTYPES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default=None, help='also write the JSON lines here')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import flash_attention as fa
    out = open(args.out, 'w') if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + '\n')

    with tempfile.TemporaryDirectory() as root:
        builds = {name: build_variant(fa, name, 'flash_hopper.cuh', [sub], 'flash_bf16.cu', root)
                  for name, sub in VARIANTS.items()}
        builds.update({name: build_variant(fa, name, 'headmean_hopper.cuh', subs,
                                           'headmean_bf16.cu', root)
                       for name, subs in B3_VARIANTS.items()})
        fa.build()
        libs = {'shipped': fa._lib('flash', torch.bfloat16)}
        b3_libs = {}
        for name, (proc, path) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f'{name}: nvcc failed:\n{log[-3000:]}')
            spills = [line for line in chip_smoke.ptxas_summary(log)
                      if 'pingpong' in line or 'headmean_cluster' in line]
            emit({'variant': name, 'ptxas': spills})
            if name in B3_VARIANTS:
                b3_libs[name] = load(fa, path, ('dft_headmean_probs', 'dft_headmean_cluster_slots'))
            else:
                libs[name] = load(fa, path, ('dft_flash_attention_forward',
                                             'dft_flash_cluster_slots'))
        gen = torch.Generator(device='cuda').manual_seed(0)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for shape in B1_SHAPES:
            b, h, sq, sk, d = shape
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device='cuda').to(torch.bfloat16)
                       for s in (sq, sk, sk))
            ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
            o = fa.flash_output(q)
            strides = fa._tma_stride_array('x', (('q', q), ('k', k), ('v', v), ('o', o)))
            rec = {'kernel': 'flash_attention', 'shape': shape}
            for _ in range(2):
                for name, lib in libs.items():
                    if name == 'no-cluster':
                        grid = fa.persistent_grid(b * h * -(-sq // fa.FLASH_BLOCK_ROWS), sms)
                    else:
                        grid = fa.flash_grid(b, h, sq, lib.dft_flash_cluster_slots(d, 2))
                    run = lambda: lib.dft_flash_attention_forward(  # noqa: E731
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, h, sq,
                        sk, d, 2, d ** -0.5, strides, grid, fa._stream(q))
                    if run():
                        raise RuntimeError(f'{name} failed to launch at {shape}')
                    torch.cuda.synchronize()
                    rel = ((o.float() - ref.float()).norm() / ref.float().norm()).item()
                    if not rel <= chip_smoke.TOL['bfloat16']:
                        raise RuntimeError(f'{name} at {shape}: relative L2 {rel}')
                    rec.setdefault(name, []).append(chip_smoke.graph_ms(torch, run))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            rec['sdpa'] = chip_smoke.graph_ms(torch, lambda: sdpa(q, k, v, scale=d ** -0.5))
            emit(rec)
            del q, k, v, ref, o
        lib = fa._lib('headmean', torch.bfloat16)
        for shape in B3_SHAPES:
            b, h, sq, sk, d = shape
            q, k, v = (torch.randn(b, h, s, d, generator=gen, device='cuda').to(torch.bfloat16)
                       for s in (sq, sk, sk))
            lse = fa.flash_attention_with_lse(q, k, v, scale=d ** -0.5)[1]
            o = torch.empty(b, sq, sk, dtype=q.dtype, device='cuda')
            strides = fa._tma_stride_array('x', (('q', q), ('k', k)))
            slots = fa._cluster_slots('headmean', torch.bfloat16, d, q.device)
            units = b * -(-sq // 256) * -(-sk // 256)
            chosen = fa.headmean_clusters(b, sq, sk, d, sms, slots)
            rec = {'kernel': 'headmean_probs', 'shape': shape, 'slots': slots, 'chosen': chosen}
            runs = [(f'clusters={n}', lib, n)
                    for n in sorted({0, fa.persistent_grid(units, slots), min(units, slots)})]
            if chosen:
                runs += [(f'{name} clusters={chosen}', vlib, chosen)
                         for name, vlib in b3_libs.items()]
            for key, blib, clusters in runs:
                run = lambda: blib.dft_headmean_probs(  # noqa: E731
                    q.data_ptr(), k.data_ptr(), lse.data_ptr(), o.data_ptr(), b, h, sq, sk, d, 2,
                    d ** -0.5, strides, clusters, fa._stream(q))
                if run():
                    raise RuntimeError(f'headmean {key} at {shape} failed')
                rec[key] = [chip_smoke.graph_ms(torch, run) for _ in range(2)]
            emit(rec)
            del q, k, v, lse, o
    emit({'card': chip_smoke.card_line()})
    return 0


if __name__ == '__main__':
    sys.exit(main())
