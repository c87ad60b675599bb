"""CLIP text encoder (port of ``diffusion_feature_tpu/models/clip_text.py``)
with the transformers checkpoint key names (``text_model.encoder.layers.N...``,
``text_projection``).

SDXL and Playground v2 use CLIP ViT-L (hidden_states[-2]) and OpenCLIP bigG
(hidden_states[-2] plus the pooled EOS token through ``text_projection``);
SD-1.5 uses CLIP ViT-L's final-layernormed output and no pooled embedding,
SD-2.1 OpenCLIP ViT-H's (23 of its 24 layers, as diffusers ships it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_fused


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = 'quick_gelu'
    layer_norm_eps: float = 1e-5
    projection_dim: Optional[int] = None   # set -> has a text_projection head
    eos_token_id: int = 49407

    @staticmethod
    def from_diffusers_config(d: dict, base: Optional['CLIPTextConfig'] = None
                              ) -> 'CLIPTextConfig':
        """Adapt a transformers CLIPTextConfig json, as the JAX package
        does.  Whether a text_projection head exists follows the
        checkpoint's ``architectures`` list; without one, ``base``'s choice
        is kept (the pipeline's contract)."""
        base = base if base is not None else CLIPTextConfig()
        archs = d.get('architectures') or []
        if any('WithProjection' in a for a in archs):
            projection_dim = d.get('projection_dim', base.projection_dim)
        elif archs:
            projection_dim = None
        else:
            projection_dim = base.projection_dim
        return CLIPTextConfig(
            vocab_size=d.get('vocab_size', base.vocab_size),
            hidden_size=d.get('hidden_size', base.hidden_size),
            intermediate_size=d.get('intermediate_size', base.intermediate_size),
            num_hidden_layers=d.get('num_hidden_layers', base.num_hidden_layers),
            num_attention_heads=d.get('num_attention_heads', base.num_attention_heads),
            max_position_embeddings=d.get('max_position_embeddings',
                                          base.max_position_embeddings),
            hidden_act=d.get('hidden_act', base.hidden_act),
            layer_norm_eps=d.get('layer_norm_eps', base.layer_norm_eps),
            projection_dim=projection_dim,
            eos_token_id=d.get('eos_token_id', base.eos_token_id),
        )

    def to_diffusers_config(self) -> dict:
        arch = 'CLIPTextModelWithProjection' if self.projection_dim else 'CLIPTextModel'
        return {'architectures': [arch], 'model_type': 'clip_text_model',
                **dataclasses.asdict(self)}


CLIP_VIT_L = CLIPTextConfig()
OPENCLIP_VIT_H = CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                                num_hidden_layers=23, num_attention_heads=16,
                                hidden_act='gelu')
OPENCLIP_BIGG = CLIPTextConfig(hidden_size=1280, intermediate_size=5120,
                               num_hidden_layers=32, num_attention_heads=20,
                               hidden_act='gelu', projection_dim=1280)


def tiny_clip_config(hidden: int = 32, projection_dim=None) -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=1000, hidden_size=hidden,
                          intermediate_size=hidden * 4, num_hidden_layers=2,
                          num_attention_heads=2, projection_dim=projection_dim,
                          eos_token_id=999)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        a = attention_fused(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.heads,
                            mask=mask)
        return self.out_proj(a)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == 'quick_gelu' else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """forward(input_ids) -> (last_hidden_state, pooled, hidden_states).

    ``hidden_states[i]`` is the input to layer i, so hidden_states[-2] is the
    penultimate layer's output (what SDXL's encode_prompt uses).  Pooling
    takes the first EOS token of the final-layernormed sequence, through
    ``text_projection`` when the config has one."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = (nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
                                if cfg.projection_dim is not None else None)

    def forward(self, input_ids):
        tm = self.text_model
        x = tm.embeddings(input_ids)
        s = input_ids.shape[1]
        # built in fp32: -3.4e38 overflows bf16 and rounds to -inf on the
        # cast, as in the JAX package
        causal = torch.full((s, s), -3.4e38, device=x.device).triu(1).to(x.dtype)
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal[None, None])
            hidden_states.append(x)
        last = tm.final_layer_norm(x)
        eos_pos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return last, pooled, tuple(hidden_states)
