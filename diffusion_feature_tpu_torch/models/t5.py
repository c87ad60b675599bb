"""T5 v1.1 encoder (port of ``diffusion_feature_tpu/models/t5.py``), the
text encoder of PixArt-alpha and PixArt-Sigma (and later Flux and IF), with
transformers' ``T5EncoderModel`` key names (``shared``,
``encoder.block.N.layer.0.SelfAttention.{q,k,v,o}``,
``...layer.1.DenseReluDense.{wi_0,wi_1,wo}``, ``encoder.final_layer_norm``),
so a ``text_encoder/`` dir loads with no renames.

Relative-position-bias attention (32 buckets, 128 max distance; the bias
table sits in block 0 and serves every layer), unscaled scores, a -1e9
additive mask on padded keys; T5's RMS norm in fp32 (no mean, no bias);
the gated-GELU feed-forward; a final RMS norm.  Attention is plain matrix
products, as in the JAX package (no kernel): the explicit fp32-score path.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_with_probs_heads, merge_heads, split_heads
from ..roadmap import not_ported


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    # int8 weight-only projections (the JAX package's Flux T5); not ported
    quantize_int8: bool = False

    @staticmethod
    def from_diffusers_config(d: dict, base: Optional['T5Config'] = None) -> 'T5Config':
        """Adapt a transformers T5Config json (a checkpoint's text_encoder
        dir), as the JAX ``T5Config.from_hf_config``: keys missing from the
        json keep ``base``'s values, and quantize_int8 carries over."""
        b = base if base is not None else T5Config()
        return T5Config(**{f.name: d.get(f.name, getattr(b, f.name))
                           for f in dataclasses.fields(T5Config) if f.name != 'quantize_int8'},
                        quantize_int8=b.quantize_int8)

    def to_diffusers_config(self) -> dict:
        fields = dataclasses.asdict(self)
        del fields['quantize_int8']
        return {'architectures': ['T5EncoderModel'], 'model_type': 't5',
                'feed_forward_proj': 'gated-gelu', 'is_gated_act': True,
                'dense_act_fn': 'gelu_new', **fields}


T5_XXL = T5Config()


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=1000, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """T5's bidirectional bucketing, on the host (the positions are static)."""
    ret = np.zeros_like(relative_position)
    n = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n
    rp = np.abs(relative_position)
    max_exact = n // 2
    is_small = rp < max_exact
    large = max_exact + (np.log(np.maximum(rp, 1) / max_exact)
                         / np.log(max_distance / max_exact) * (n - max_exact)).astype(np.int64)
    large = np.minimum(large, n - 1)
    ret += np.where(is_small, rp, large)
    return ret


class T5LayerNorm(nn.Module):
    """RMS norm in fp32, scaled, cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight * xf).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads = cfg.num_heads
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def forward(self, x, bias):
        """``bias``: the position bias plus the key mask, (B or 1, H, S, S),
        added to the unscaled fp32 scores."""
        qh, kh, vh = (split_heads(p(x), self.heads) for p in (self.q, self.k, self.v))
        out, _ = attention_with_probs_heads(qh, kh, vh, scale=1.0, mask=bias)
        return self.o(merge_heads(out))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate='tanh') * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias),
                                    T5LayerFF(cfg)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """``forward(input_ids (B, S), attention_mask (B, S) of 1/0 or None)``
    -> the final-normed hidden states (B, S, d_model)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.quantize_int8:
            raise not_ported('the int8 weight-only T5 (quantize_int8)',
                             'Int8 weight-only dense', queue='B')
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, H, S, S) bias of query i and key j from the bucket of j - i."""
        cfg = self.cfg
        pos = np.arange(s)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        return table(torch.as_tensor(buckets, device=device)).permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        x = self.shared(input_ids)
        bias = self.position_bias(input_ids.shape[1], input_ids.device).float()
        if attention_mask is not None:
            bias = bias + (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


_JAX_BLOCK_KEY = re.compile(r'^block_(\d+)_(attn_[qkvo]|ln1|ln2|wi_0|wi_1|wo)_weight$')
_JAX_BLOCK_PARTS = {'ln1': 'layer.0.layer_norm', 'ln2': 'layer.1.layer_norm',
                    'wi_0': 'layer.1.DenseReluDense.wi_0', 'wi_1': 'layer.1.DenseReluDense.wi_1',
                    'wo': 'layer.1.DenseReluDense.wo'}
_JAX_TOP_KEYS = {
    'relative_attention_bias_weight':
        'encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight',
    'final_layer_norm_weight': 'encoder.final_layer_norm.weight',
    'shared_weight': 'shared.weight',
}


def _from_jax_name(key: str) -> str:
    """A key in the JAX ``T5EncoderModel``'s parameter names (``block_N_attn_q``,
    ``block_N_ln1``, ..., as the JAX package's synthetic checkpoints write
    them) in transformers' name; any other key as it is."""
    flat = key.replace('.', '_')
    m = _JAX_BLOCK_KEY.match(flat)
    if m:
        part = m.group(2)
        part = (f'layer.0.SelfAttention.{part[-1]}' if part.startswith('attn_')
                else _JAX_BLOCK_PARTS[part])
        return f'encoder.block.{m.group(1)}.{part}.weight'
    return _JAX_TOP_KEYS.get(flat, key)


def t5_checkpoint_state(state: dict) -> dict:
    """A T5 checkpoint's tensors under this module's keys, as the JAX
    loader reads them (``rename_t5_keys``): transformers' keys as they
    are, the JAX package's own names renamed, and the tied embedding taken
    from ``encoder.embed_tokens`` where a file holds only that name."""
    state = {_from_jax_name(k): v for k, v in state.items()}
    if 'shared.weight' not in state and 'encoder.embed_tokens.weight' in state:
        state['shared.weight'] = state['encoder.embed_tokens.weight']
    return state


def jax_param_name(key: str) -> str:
    """The JAX ``T5EncoderModel``'s name of a port parameter, in the dotted
    form ``convert.params_from_jax`` normalises (the JAX ``rename_t5_keys``)."""
    k = (key.replace('encoder.block.', 'block_')
         .replace('.layer.0.SelfAttention.', '.attn.')
         .replace('.layer.0.layer_norm.', '.ln1.')
         .replace('.layer.1.DenseReluDense.', '.')
         .replace('.layer.1.layer_norm.', '.ln2.')
         .replace('encoder.final_layer_norm.', 'final_layer_norm.'))
    return 'relative_attention_bias.weight' if k.endswith('relative_attention_bias.weight') else k
