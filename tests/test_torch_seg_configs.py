"""The twelve shipped segmentation configs (``seg_configs/*.json``) build
their segmentor in the port: ``train_segmentation.segmentor_from_config``
on the meta device, each extractor stood in for by a recorder of its
arguments (a real-size extractor is the chip's work: ``chip_smoke.py``
trains ``ade_full.json``).  Every feature layer the head adapts is one the
extractor was asked for and that the model has, with the declared
channels (the port's own enumeration, at real size on the meta device),
and each level of the head takes the sum of them.
"""

import glob
import json
import os

import pytest
import torch

from diffusion_feature_tpu_torch import train_segmentation as trainer
from diffusion_feature_tpu_torch.enumerate_layers import enumerate_layers
from diffusion_feature_tpu_torch.tasks.segmentation import segmentor as segmentor_mod

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), '..', 'seg_configs',
                                        '*.json')))
_enumerations = {}


def _enumerated(version, img_size):
    if (version, img_size) not in _enumerations:
        _enumerations[version, img_size] = enumerate_layers(version, img_size)
    return _enumerations[version, img_size]


class _RecordedExtractor:
    """The arguments of one FeatureExtractor the segmentor builds."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def encode_prompt(self, prompt):
        return (None, None, None, None)

    def offload_prompt_encoder(self, persistent=False):
        pass


def test_twelve_configs_ship():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: os.path.basename(p)[:-5])
def test_shipped_config_builds_its_segmentor(monkeypatch, path):
    with open(path) as f:
        cfg = json.load(f)
    monkeypatch.setattr(segmentor_mod, 'FeatureExtractor', _RecordedExtractor)
    with torch.device('meta'):   # the head's shapes, no values
        seg = trainer.segmentor_from_config(cfg, device='meta')
    dfs = cfg['diffusion_feature'] if isinstance(cfg['diffusion_feature'], list) \
        else [cfg['diffusion_feature']]
    fls = cfg['feature_layers'] if seg.multi else [cfg['feature_layers']]
    assert [ex['model'].kwargs['version'] for ex in seg.extractors] == [d['version'] for d in dfs]
    levels = [0] * max(len(fl) for fl in fls)
    for mi, (df, fl, ex) in enumerate(zip(dfs, fls, seg.extractors)):
        kw = ex['model'].kwargs
        assert (kw['layer'], kw['img_size'], kw['attention']) == (
            df['layer'], df['img_size'], df.get('attention'))
        shapes = _enumerated(df['version'], df['img_size'])
        suffix = '' if not seg.multi else f'_m{mi}'
        for level, lvl in enumerate(fl):
            for lid, channels in lvl:
                if lid == 'attn':
                    # 77 prompt tokens x 2 size groups x the store's categories
                    assert channels == 77 * 2 * len(df['attention'])
                else:
                    assert df['layer'].get(lid) and shapes[lid][1] == channels, lid
                adapter = getattr(seg.head, f"adapter{suffix}_{lid.replace('-', '_')}")
                assert adapter.conv1.in_channels == channels, lid
                levels[level] += channels
    for level, channels in enumerate(levels):
        assert getattr(seg.head.decode_head, f'lateral_{level}', None) is None or \
            seg.head.decode_head.get_submodule(f'lateral_{level}').conv.in_channels == channels
    assert seg.head.decode_head.bottleneck.conv.in_channels == levels[-1] + len(
        cfg.get('pool_scales', (1, 2))) * cfg.get('head_channels', 512)
    assert seg.head.decode_head.conv_seg.out_channels == cfg['num_classes']
