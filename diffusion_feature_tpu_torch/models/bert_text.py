"""BERT text encoder of HunyuanDiT (port of
``diffusion_feature_tpu/models/bert_text.py``), with transformers'
``BertModel`` key names (``embeddings.{word,position,token_type}_embeddings``,
``embeddings.LayerNorm``, ``encoder.layer.N.attention.self.{query,key,value}``,
``...attention.output.{dense,LayerNorm}``, ``...intermediate.dense``,
``...output.{dense,LayerNorm}``), so a ``text_encoder/`` dir loads with no
renames (its ``pooler`` is unused, as in the JAX package).

Post-LN encoder: token, position and (all-zero) token-type embeddings,
LayerNorm; per layer self-attention with the additive -1e9 key mask, the
residual and LayerNorm, then an exact-GELU MLP, the residual and
LayerNorm.  The 77-token attention takes the explicit path (its mask keeps
it off the kernels), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_fused


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 47020
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def from_hf_config(d: dict, base: Optional['BertConfig'] = None) -> 'BertConfig':
        """Adapt a transformers BertConfig json (a checkpoint's text_encoder
        dir); keys missing from the json keep ``base``'s values."""
        b = base if base is not None else BertConfig()
        return BertConfig(**{f.name: d.get(f.name, getattr(b, f.name))
                             for f in dataclasses.fields(BertConfig)})

    def to_diffusers_config(self) -> dict:
        return {'architectures': ['BertModel'], 'model_type': 'bert', 'hidden_act': 'gelu',
                **dataclasses.asdict(self)}


HUNYUAN_BERT = BertConfig()


def tiny_bert_config() -> BertConfig:
    return BertConfig(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.query, self.key, self.value = nn.Linear(h, h), nn.Linear(h, h), nn.Linear(h, h)


class BertSubLayerOutput(nn.Module):
    """dense -> residual -> LayerNorm (transformers' BertSelfOutput and
    BertOutput)."""

    def __init__(self, in_dim: int, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(in_dim, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSubLayerOutput(cfg.hidden_size, cfg)
        self.heads = cfg.num_attention_heads

    def forward(self, x, mask):
        sa = self.self
        attn = attention_fused(sa.query(x), sa.key(x), sa.value(x), self.heads, mask=mask)
        return self.output(attn, x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSubLayerOutput(cfg.intermediate_size, cfg)

    def forward(self, x, mask=None):
        x = self.attention(x, mask)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class BertTextModel(nn.Module):
    """``forward(input_ids (B, S), attention_mask (B, S) of 1/0 or None)``
    -> last_hidden_state (B, S, hidden_size)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        x = self.embeddings(input_ids)
        mask = None
        if attention_mask is not None:
            mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return x


def bert_checkpoint_state(state: dict) -> dict:
    """A BERT checkpoint's tensors under this module's keys, as the JAX
    loader reads them (``rename_bert_keys``): a ``bert.`` prefix (a
    task model's BertModel) dropped, ``position_ids`` buffers skipped."""
    return {k[len('bert.'):] if k.startswith('bert.') else k: v for k, v in state.items()
            if not k.endswith('position_ids')}


def jax_param_name(key: str) -> str:
    """The JAX ``BertTextModel``'s name of a port parameter, in the dotted
    form ``convert.params_from_jax`` normalises (the JAX
    ``rename_bert_keys``, copied)."""
    return (key.replace('embeddings.word_embeddings.', 'word_embeddings.')
            .replace('embeddings.position_embeddings.', 'position_embeddings.')
            .replace('embeddings.token_type_embeddings.', 'token_type_embeddings.')
            .replace('embeddings.LayerNorm.', 'LayerNorm.')
            .replace('encoder.layer.', 'layer_')
            .replace('.attention.self.query.', '.attention_self_query.')
            .replace('.attention.self.key.', '.attention_self_key.')
            .replace('.attention.self.value.', '.attention_self_value.')
            .replace('.attention.output.dense.', '.attention_output_dense.')
            .replace('.attention.output.LayerNorm.', '.attention_output_LayerNorm.')
            .replace('.intermediate.dense.', '.intermediate_dense.')
            .replace('.output.dense.', '.output_dense.')
            .replace('.output.LayerNorm.', '.output_LayerNorm.'))
