"""Activation taps: static layer selection (port of
``diffusion_feature_tpu/taps.py``).

Each tapped module is built with the request (``TapSpec``) and its
``tap_name``, and keeps a ``TapSite``: the ids it can emit and the subset
that was requested.  Its forward writes only requested ids into the dict
the caller passes along; no forward hooks are used.  Values are stored in
the layout the JAX ``sow_tap`` produces after its 'nhwc' transpose: conv
features NCHW, token features (B, S, C), attention maps (B, H, Sq, Sk).

The layer-id grammar is the JAX package's (``diffusion_feature_tpu/taps.py``
docstring), e.g. ``up-level1-repeat0-vit-block0-cross-q``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping, Optional, Sequence

# cross-attention k/v are token-aligned with the prompt, not the image, so
# the store drops them (reference feature_extractor.py:38-39)
_FILTERED_SUBSTRINGS = ('cross-k', 'cross-v')


def is_filtered_id(tap_id: str) -> bool:
    return any(s in tap_id for s in _FILTERED_SUBSTRINGS)


@dataclasses.dataclass(frozen=True)
class TapSpec:
    """Which activation taps to capture.  ``accept_all`` is the reference's
    show-all-layers mode, where an empty config stores every tap."""

    ids: frozenset = frozenset()
    accept_all: bool = False

    @staticmethod
    def none() -> 'TapSpec':
        return TapSpec()

    @staticmethod
    def all() -> 'TapSpec':
        return TapSpec(accept_all=True)

    @staticmethod
    def from_config(config) -> 'TapSpec':
        """From a layer config: JSON path or inline JSON, dict[str, bool], or
        an iterable of ids.  None or an empty config selects accept-all."""
        if config is None:
            return TapSpec.all()
        if isinstance(config, str):
            if config.lstrip().startswith('{'):
                config = json.loads(config)
            else:
                with open(config, 'r') as f:
                    config = json.load(f)
        if isinstance(config, Mapping):
            ids = frozenset(k for k, v in config.items() if v)
        elif isinstance(config, Iterable):
            ids = frozenset(config)
        else:
            raise TypeError(f'unsupported layer config type: {type(config)}')
        if not ids:
            return TapSpec.all()
        return TapSpec(ids=ids)

    def wants(self, tap_id: str) -> bool:
        if is_filtered_id(tap_id):
            return False
        return self.accept_all or tap_id in self.ids


EMPTY = TapSpec.none()


def child_id(prefix: str, *parts) -> str:
    """Join id parts with '-' (reference ``'-'.join([module_id, feat_id])``)."""
    items = [prefix] if prefix else []
    items += [str(p) for p in parts]
    return '-'.join(items)


class TapSite:
    """The tap ids one module declares (``ids``: feature name -> full id) and
    which of them the request selected.  ``gathers`` (feature name -> a
    function) put a sharded module's piece back together (``parallel/mesh.py``)
    before it is stored."""

    def __init__(self, spec: TapSpec, prefix: str, feats: Sequence[str]):
        self.ids = {f: child_id(prefix, f) for f in feats}
        self._wanted = {f: i for f, i in self.ids.items() if spec.wants(i)}
        self.gathers = {}

    def wants(self, feat: str) -> bool:
        return feat in self._wanted

    def put(self, out: Optional[dict], feat: str, value) -> None:
        tap_id = self._wanted.get(feat)
        if tap_id is not None and out is not None:
            gather = self.gathers.get(feat)
            out[tap_id] = value if gather is None else gather(value)


def declared_ids(module) -> set:
    """Every tap id the modules under ``module`` (an ``nn.Module``) declare."""
    return {i for m in module.modules() if isinstance(getattr(m, 'tap_site', None), TapSite)
            for i in m.tap_site.ids.values()}
