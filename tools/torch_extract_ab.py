#!/usr/bin/env python3
"""Time one path of the PyTorch port for one checkout of the repository.

    python3 tools/torch_extract_ab.py ROOT [--path xl|sd15_store|xl_store]

Imports ``diffusion_feature_tpu_torch`` from ROOT, builds its kernels, and
times one of ``chip_smoke.PATHS`` (default ``xl``: SDXL ``xl-practical`` at
1024^2, batch 2, t=50, random weights) with ``chip_smoke.extract_times``:
15 calls between CUDA events after three warm-up calls.  The path's
settings come from this repository's ``chip_smoke.py``, whatever ROOT is.
Prints one JSON line with the median, quartiles, min and max in ms and the
card.  To compare two checkouts on one card, run it for both in turns in
one command (A B B A), e.g. with the parent unpacked by ``git archive``
into a directory ``.gitignore`` lists.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CALLS = 15


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('root')
    ap.add_argument('--path', choices=list(chip_smoke.PATHS), default='xl')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from diffusion_feature_tpu_torch.ops import flash_attention as fa

    fa.build()
    fe, prompts, images = chip_smoke.open_path(torch, args.path)
    _, times = chip_smoke.extract_times(torch, fe, prompts, images, CALLS)
    n = len(times)
    print(json.dumps({'root': args.root, 'path': args.path, 'calls': n,
                      'median_ms': times[n // 2], 'q1_ms': times[n // 4],
                      'q3_ms': times[(3 * n) // 4], 'min_ms': times[0], 'max_ms': times[-1],
                      'card': chip_smoke.card_line()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
