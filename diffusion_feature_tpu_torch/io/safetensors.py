"""Reader and writer of the safetensors format, in torch alone (what the
JAX package takes from the ``safetensors`` package, which the port does not
need).

A file is an 8-byte little-endian header length N, N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings), then the tensors' raw
little-endian bytes, with offsets counted from the end of the header.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
    'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
    'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8, 'BOOL': torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_ALIGN = 8   # the header is padded with spaces so the data starts 8-aligned


def _read_header(buf, size: int, path: str):
    if size < 8:
        raise ValueError(f'{path}: {size} bytes, too short for a safetensors header')
    (n,) = struct.unpack('<Q', buf[:8])
    if n > size - 8:
        raise ValueError(f'{path}: header of {n} bytes in a file of {size}')
    try:
        header = json.loads(bytes(buf[8:8 + n]))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f'{path}: header is not JSON: {e}') from e
    if not isinstance(header, dict):
        raise ValueError(f'{path}: header is not a JSON object')
    header.pop('__metadata__', None)
    data_len = size - 8 - n
    spans = []
    for name, info in header.items():
        if not isinstance(info, dict):
            raise ValueError(f'{path}: {name} has no tensor record')
        dtype = DTYPES.get(info.get('dtype'))
        if dtype is None:
            raise ValueError(f'{path}: {name} has unknown dtype {info.get("dtype")!r}')
        begin, end = info['data_offsets']
        numel = 1
        for s in info['shape']:
            numel *= s
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f'{path}: {name} offsets [{begin}, {end}] leave the data '
                             f'section of {data_len} bytes')
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f'{path}: {name} holds {end - begin} bytes, its dtype and '
                             f'shape {info["shape"]} need {numel * dtype.itemsize}')
        spans.append((begin, end, name))
    spans.sort()
    for (_, end, a), (begin, _, b) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f'{path}: {a} and {b} overlap')
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file.  The file is memory-mapped
    (copy-on-write) and each tensor is a view of its bytes: nothing is
    copied until a tensor is read, and the map lives as long as a tensor
    does.  BF16 never passes through numpy, which has no bfloat16."""
    with open(path, 'rb') as f:
        size = f.seek(0, 2)
        if size == 0:
            raise ValueError(f'{path}: empty file')
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, start = _read_header(buf, size, path)
    out = {}
    for name, info in header.items():
        dtype = DTYPES[info['dtype']]
        shape = tuple(info['shape'])
        begin, end = info['data_offsets']
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=start + begin)
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (on any device) as one safetensors file, streaming
    each tensor's bytes; returns the bytes written.  Wider dtypes come first
    (as the ``safetensors`` package orders them), so every tensor starts at
    a multiple of its item size."""
    order = sorted(tensors, key=lambda k: -tensors[k].element_size())
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f'{name}: dtype {t.dtype} has no safetensors name')
        nbytes = t.numel() * t.element_size()
        header[name] = {'dtype': _NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header = {'__metadata__': {str(k): str(v) for k, v in metadata.items()}, **header}
    blob = json.dumps(header, separators=(',', ':')).encode()
    blob += b' ' * (-(8 + len(blob)) % _ALIGN)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name]
            if t.numel():
                raw = t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                f.write(memoryview(raw.numpy()))
    return 8 + len(blob) + offset
