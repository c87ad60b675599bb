"""The kernel sources against the build and the bindings, read as text
(no compiler): every header a source includes is hashed into its build,
every C entry point takes as many parameters as ctypes passes it, and every
source the build names exists."""

import re

import pytest

from diffusion_feature_tpu_torch.ops import flash_attention as fa

_FILES = sorted(p for p in fa._CSRC.iterdir() if p.suffix in ('.cu', '.cuh'))


def _entries():
    """(file name, function name, parameter count) of every extern "C"
    definition under csrc, those inside a macro too."""
    found = []
    for path in _FILES:
        text = path.read_text().replace('\\\n', ' ')
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p for p in m.group(2).split(',') if p.strip()]
            found.append((path.name, m.group(1), len(params)))
    return found


@pytest.mark.parametrize('path', _FILES, ids=[p.name for p in _FILES])
def test_includes_are_hashed(path):
    """A quoted include names a header in ``_HEADERS`` (whose bytes every
    build hashes, so a changed header rebuilds) or a source."""
    known = {p.name for p in fa._HEADERS} | {p.name for p in fa._SOURCES.values()}
    for name in re.findall(r'#include "([^"]+)"', path.read_text()):
        assert name in known, f'{path.name} includes {name}, which _HEADERS does not list'


def test_entry_points_take_what_ctypes_passes():
    """Each extern "C" entry takes len(_ARGTYPES[name]) parameters: a
    mismatch would pass garbage without an error."""
    entries = _entries()
    assert {name for _, name, _ in entries} == set(fa._ARGTYPES)
    for file_name, name, count in entries:
        assert count == len(fa._ARGTYPES[name]), (
            f'{file_name}: {name} takes {count} parameters, ctypes passes '
            f'{len(fa._ARGTYPES[name])}')


def test_sources_and_headers_exist():
    """Every library's source and every hashed header is in the checkout,
    and every source under csrc is built."""
    for path in (*fa._SOURCES.values(), *fa._HEADERS):
        assert path.is_file(), path
    built = {p.name for p in fa._SOURCES.values()}
    assert {p.name for p in _FILES if p.suffix == '.cu'} == built
    assert {p.name for p in _FILES if p.suffix == '.cuh'} == {p.name for p in fa._HEADERS}


# The W8A16 kernel of every phase-2 shape of chip_smoke.py (bf16, aligned,
# on a card of 132 SMs), as ops/quant.int8_route chooses it.
_INT8_PATH_ROUTES = {
    (8192, 3072, 3072): 'tma256', (8192, 3072, 12288): 'tma256', (8192, 12288, 3072): 'tma256',
    (1024, 3072, 3072): 'tma256', (1024, 3072, 12288): 'tma256', (1024, 12288, 3072): 'tma256',
    (2, 3072, 18432): 'streaming', (2, 3072, 9216): 'streaming',
    (9216, 3072, 12288): 'tma256', (9216, 3072, 3072): 'tma256', (9216, 15360, 3072): 'tma256',
    (1024, 4096, 3072): 'tma256', (512, 4096, 4096): 'tma128', (512, 4096, 10240): 'tma256',
    (512, 10240, 4096): 'tma128', (1024, 4096, 4096): 'tma256', (1024, 4096, 10240): 'tma256',
    (1024, 10240, 4096): 'tma256'}


def _route(m, k, n, dtype=None, aligned=True, sms=132):
    import torch

    from diffusion_feature_tpu_torch.ops import quant
    return quant.ROUTES[quant.int8_route(m, n, k, dtype or torch.bfloat16, aligned, sms)]


def test_int8_route_at_every_path_shape_and_the_unaligned_ones():
    """``quant.int8_route`` (the W8A16 kernel of a call, which the C entry
    takes as ``route``): the TMA or the streaming kernel at every phase-2
    shape (the int8 Flux extract's and T5-XXL's at 512 and 1024 rows) in bf16
    and fp16; the cp.async kernel where TMA cannot describe the rows (K not
    a multiple of 16: phase 2's ragged (37, 1000, 333) and K = 100; a weight
    not 16-byte aligned) and for every fp32 call."""
    import torch

    import chip_smoke
    shapes = [s for s, _ in chip_smoke.int8_phase2_shapes()]
    assert sorted(set(shapes)) == sorted(_INT8_PATH_ROUTES)
    for m, k, n in shapes:
        assert _route(m, k, n) == _INT8_PATH_ROUTES[m, k, n], (m, k, n)
        assert _route(m, k, n, torch.float16) == _INT8_PATH_ROUTES[m, k, n], (m, k, n)
        assert _route(m, k, n, torch.float32) == 'staged'
        assert _route(m, k, n, aligned=False) == 'staged'
    for m, k, n in (chip_smoke.INT8_RAGGED, (5, 100, 50), (2, 3080, 9216)):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            assert _route(m, k, n, dtype) == 'staged', (m, k, n, dtype)


def test_int8_route_edges():
    """The streaming kernel up to ``STREAM_MAX_ROWS`` rows and the TMA kernel
    from one row more; 128-row tiles where 256-row ones would take more
    than 1 / ``WIDE_TILE_COST`` as many waves (N = 18432 at 17 rows, a
    second wave of 256-row tiles at (1408, 3072, 3072)), and the count of
    SMs read from the card, not assumed."""
    from diffusion_feature_tpu_torch.ops import quant
    limit = quant.STREAM_MAX_ROWS
    assert limit == 16
    assert [_route(m, 3072, 18432) for m in (1, limit, limit + 1)] == [
        'streaming', 'streaming', 'tma128']
    assert [_route(m, 3072, 3072) for m in (1280, 1408, 2048)] == ['tma256', 'tma128', 'tma256']
    assert [_route(1024, 3072, 3072, sms=sms) for sms in (132, 200)] == ['tma256', 'tma128']
