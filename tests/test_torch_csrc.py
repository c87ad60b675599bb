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
