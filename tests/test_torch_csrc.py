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


# B1/B2's ping-pong kernel and B3's cluster kernel: the host's choices
# (ops/flash_attention.py) against the widths the sources build them for.
def _source(name):
    return (fa._CSRC / name).read_text()


def test_cluster_widths_match_the_sources():
    """``FLASH_CLUSTER_WIDTHS``/``FLASH_CLUSTER`` are flash_hopper.cuh's
    ping-pong widths and cluster size, ``HEADMEAN_CLUSTER_WIDTHS``
    headmean_hopper.cuh's cluster kernel's widths: a width the host routes
    to a kernel the library lacks would fail its launch."""
    flash = _source('flash_hopper.cuh')
    m = re.search(r'kPingPong = ((?:D == \d+(?: \|\| )?)+);', flash)
    assert m and tuple(int(w) for w in re.findall(r'\d+', m.group(1))) == fa.FLASH_CLUSTER_WIDTHS
    assert f'kCluster = kPingPong ? {fa.FLASH_CLUSTER} : 1;' in flash
    head = _source('headmean_hopper.cuh')
    m = re.search(r'kClustered = ((?:D == \d+(?: \|\| )?)+);', head)
    assert m and tuple(int(w) for w in re.findall(r'\d+', m.group(1))) == \
        fa.HEADMEAN_CLUSTER_WIDTHS
    for w in fa.HEADMEAN_CLUSTER_WIDTHS:
        assert f'case {w}: return headmean_slots<T, {w}>();' in head
    for w in fa.FLASH_CLUSTER_WIDTHS:
        assert f'case {w}: return pingpong_slots<T, {w}>();' in flash


@pytest.mark.parametrize('items,slots,grid', [
    (288, 132, 96), (264, 132, 132), (265, 132, 89), (131, 132, 131), (1, 132, 1),
    (1728, 132, 124), (576, 66, 64), (512, 30, 29), (2048, 30, 30)])
def test_persistent_grid_spreads_the_rounds(items, slots, grid):
    """``persistent_grid``: as few units as finish in the rounds ``slots``
    units need: never more rounds than ceil(items / slots), never more
    units than slots or items."""
    got = fa.persistent_grid(items, slots)
    assert got == grid
    rounds = -(-items // slots)
    assert got <= min(items, slots) and -(-items // got) == rounds


def test_persistent_grid_refuses_empty_work():
    for items, slots in ((0, 132), (10, 0)):
        with pytest.raises(ValueError):
            fa.persistent_grid(items, slots)


# (b, h, sq) of every B1/B2 call at a ping-pong width in chip_smoke.py's
# phase 2, with the block count flash_grid gives on an H100 (66 clusters
# of two CTAs at once)
_FLASH_GRIDS = {(2, 24, 4608): 124, (1, 24, 4608): 124, (2, 24, 1536): 116, (1, 24, 1536): 96,
                (2, 12, 4608): 124, (2, 24, 2560): 120, (2, 24, 2304): 124, (2, 16, 4096): 128,
                (2, 16, 1024): 128, (2, 16, 2048): 128, (1, 16, 1000): 128, (1, 1, 1): 2}


@pytest.mark.parametrize('b,h,sq', list(_FLASH_GRIDS), ids=[str(k) for k in _FLASH_GRIDS])
def test_flash_grid_at_the_path_shapes(b, h, sq):
    """``flash_grid``: an even block count (clusters of two), one cluster
    per pair of 128-query tiles of a head at most, as many rounds as 66
    clusters need."""
    grid = fa.flash_grid(b, h, sq, 66)
    assert grid == _FLASH_GRIDS[b, h, sq]
    pairs = b * h * -(-(-(-sq // fa.FLASH_BLOCK_ROWS)) // fa.FLASH_CLUSTER)
    assert grid % fa.FLASH_CLUSTER == 0 and grid // 2 <= pairs
    assert -(-pairs // (grid // 2)) == -(-pairs // 66)


@pytest.mark.parametrize('shape,clusters', [
    ((2, 4096, 4096, 72), 29), ((2, 4096, 4096, 88), 29), ((2, 1024, 1024, 72), 0),
    ((2, 1024, 1024, 88), 0), ((1, 1000, 333, 72), 0), ((2, 2048, 2048, 72), 26),
    ((2, 2000, 2050, 72), 29), ((2, 4096, 4096, 64), 0), ((2, 4096, 4096, 128), 0),
    ((1, 4096, 4096, 72), 29), ((2, 1536, 1536, 72), 24)])
def test_headmean_clusters_at_the_path_shapes(shape, clusters):
    """``headmean_clusters`` on an H100 (132 SMs, 30 clusters of four at
    once): the cluster kernel at d=72/88 once the lone kernel's tiles take
    more than one round (PixArt's 4096 tokens), the lone kernel where they
    fit one (1024 tokens) and at every other width."""
    b, sq, sk, d = shape
    assert fa.headmean_clusters(b, sq, sk, d, 132, 30) == clusters
