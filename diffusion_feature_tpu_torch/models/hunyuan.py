"""HunyuanDiT transformer with activation taps (port of
``diffusion_feature_tpu/models/hunyuan.py``), with diffusers'
``HunyuanDiT2DModel`` key names (``pos_embed.proj``,
``time_extra_emb.{timestep_embedder,pooler,style_embedder,extra_embedder}``,
``text_embedder.linear_{1,2}``, ``text_embedding_padding``,
``blocks.N.{norm1.linear,norm1.norm,attn1,norm2,attn2,norm3,ff,skip_norm,
skip_linear}``, ``norm_out.linear``, ``proj_out``), so a ``transformer/``
dir loads with no renames.

U-ViT long skips in the second half of the blocks, AdaLayerNormShift
blocks (a timestep-conditioned shift, no scale), 2-D RoPE (the first half
of each head's rotary dims turns by the token's column, the second by its
row), per-head LayerNorm on q and k, and dual text conditioning: BERT's
77 tokens and mT5's 256 projected to BERT's width, concatenated, with a
learned padding row where the masks are 0.  The output carries the learned
sigma (2 x the latent channels; the facade keeps the first half).

Taps: ``vit-block{i}-self-{q,k,v,map}``, ``-cross-{q,k,v,map}`` and
``-ffn-inner`` (reference feature_extractor.py:250-268).  The block-level
``-out`` tap never fires in the reference (HunyuanDiTBlock is outside its
overlaid files), so the blocks declare none.  Self-attention goes to the
flash kernel (B1) where the gate admits it (4096 or 1024 tokens of 16
heads x 88); a ``-map`` tap or the attention store (place ``'up'``) takes
the explicit path and keeps the head-mean of its probabilities, as the JAX
package does (no B2/B3 here).  Cross-attention (333 keys) and the T5
attention pool (one query over 257 keys) are explicit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (attention_fused_heads, attention_with_probs_heads, merge_heads,
                             split_heads)
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel.mesh import TokenShard, cut_heads, head_mean, row_linear, span, tap_gather
from ..taps import EMPTY, TapSite, TapSpec, child_id
from .layers import ATTN_STORE, AttnStoreCfg, FeedForward, TimestepEmbedding, timestep_embedding


@dataclasses.dataclass(frozen=True)
class HunyuanConfig:
    sample_size: int = 128            # latent side at 1024 px
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8             # learned sigma
    hidden_size: int = 1408
    num_layers: int = 40
    num_attention_heads: int = 16
    cross_attention_dim: int = 1024   # BERT width / combined text width
    cross_attention_dim_t5: int = 2048
    pooled_projection_dim: int = 1024
    text_len: int = 77
    text_len_t5: int = 256
    mlp_ratio: float = 4.3056640625
    norm_eps: float = 1e-6
    use_style_cond_and_image_meta_size: bool = True
    rope_base_size: int = 32          # 512 // 8 // patch_size (the pipeline's)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_diffusers_config(d: dict) -> 'HunyuanConfig':
        """Adapt a diffusers transformer config.json as the JAX package does
        (missing keys take HunyuanDiT's values).  ``norm_eps`` and
        ``rope_base_size``, which diffusers' config does not carry, are read
        where ``to_diffusers_config`` wrote them (a tree the port saved).
        The FFN is the reference's GEGLU: a config that names another
        ``activation_fn`` (diffusers' default is 'gelu-approximate') raises
        NotImplementedError, since which FFN published weights have is an open question
        (ROADMAP.md, Queue C, "HunyuanDiT's DiT size")."""
        act = d.get('activation_fn', 'geglu')
        if act != 'geglu':
            raise NotImplementedError(f"HunyuanDiT config.json names activation_fn={act!r}; the DiT "
                             "mirrors the reference's GEGLU FFN, and whether published weights "
                             "use another is open (ROADMAP.md, Queue C, \"HunyuanDiT's DiT size\")")
        heads = d.get('num_attention_heads', 16)
        in_ch = d.get('in_channels', 4)
        return HunyuanConfig(
            sample_size=d.get('sample_size', 128),
            patch_size=d.get('patch_size', 2),
            in_channels=in_ch,
            out_channels=in_ch * 2 if d.get('learn_sigma', True) else in_ch,
            hidden_size=d.get('hidden_size', heads * d.get('attention_head_dim', 88)),
            num_layers=d.get('num_layers', 40),
            num_attention_heads=heads,
            cross_attention_dim=d.get('cross_attention_dim', 1024),
            cross_attention_dim_t5=d.get('cross_attention_dim_t5', 2048),
            pooled_projection_dim=d.get('pooled_projection_dim', 1024),
            text_len=d.get('text_len', 77),
            text_len_t5=d.get('text_len_t5', 256),
            mlp_ratio=d.get('mlp_ratio', 4.3056640625),
            norm_eps=d.get('norm_eps', 1e-6),
            use_style_cond_and_image_meta_size=d.get('use_style_cond_and_image_meta_size',
                                                     True),
            rope_base_size=d.get('rope_base_size', 32),
        )

    def to_diffusers_config(self) -> dict:
        fields = dataclasses.asdict(self)
        del fields['out_channels']
        return {'_class_name': 'HunyuanDiT2DModel', **fields,
                'learn_sigma': self.out_channels == 2 * self.in_channels,
                'attention_head_dim': self.head_dim, 'activation_fn': 'geglu',
                'norm_type': 'layer_norm'}


HUNYUAN_DIT = HunyuanConfig()


def tiny_hunyuan_config() -> HunyuanConfig:
    return HunyuanConfig(sample_size=16, hidden_size=32, num_layers=4, num_attention_heads=2,
                         cross_attention_dim=32, cross_attention_dim_t5=32,
                         pooled_projection_dim=32, text_len=8, text_len_t5=8, mlp_ratio=2.0,
                         rope_base_size=8)


def hunyuan_rope(grid: int, head_dim: int, base_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (grid^2, head_dim) RoPE tables of a square grid, positions mapped
    onto a ``base_size`` frame (the pipeline's resize-crop region): the
    first head_dim/2 dims rotate by the column, the rest by the row
    (diffusers' MAE-lineage meshgrid); tokens flatten row-major."""
    pos = np.linspace(0, base_size, grid, endpoint=False, dtype=np.float64)
    row, col = np.meshgrid(pos, pos, indexing='ij')
    ids = np.stack([col.reshape(-1), row.reshape(-1)], axis=1)   # (S, 2): w, h
    return rope_cos_sin(ids, (head_dim // 2, head_dim // 2))


class HunyuanAttention(nn.Module):
    """Self- or cross-attention with q/k/v/map taps, per-head LayerNorm on
    q and k, and RoPE on q and k (self) or on q only (cross), as
    HunyuanAttnProcessor (reference components/attention.py:368-371)."""

    def __init__(self, cfg: HunyuanConfig, is_cross: bool, taps: TapSpec = EMPTY,
                 tap_name: str = '', attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        inner, ctx_dim = cfg.hidden_size, cfg.cross_attention_dim if is_cross else cfg.hidden_size
        self.heads, self.is_cross = cfg.num_attention_heads, is_cross
        self.to_q = nn.Linear(inner, inner)
        self.to_k = nn.Linear(ctx_dim, inner)
        self.to_v = nn.Linear(ctx_dim, inner)
        self.norm_q = nn.LayerNorm(cfg.head_dim, eps=1e-6)
        self.norm_k = nn.LayerNorm(cfg.head_dim, eps=1e-6)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])
        self.tap_site = TapSite(taps, tap_name, ('q', 'k', 'v', 'map'))
        self.store_key, self.store_band = (attn_store.slot(is_cross) if attn_store is not None
                                           else (None, None))
        self.heads_total, self.head_dim = self.heads, cfg.head_dim
        self.tp = self.seq = None

    def parallelize(self, tp, seq):
        """This rank's heads of ``tp`` and tokens of ``seq`` (as
        ``layers.Attention``'s); returns the cuts."""
        cuts = {} if tp is None else cut_heads(self, tp, ('to_q', 'to_k', 'to_v'), ('to_out.0',))
        self.seq = seq
        self.tap_site.gathers = {'q': tap_gather((seq, 1), (tp, -1)),
                                 'k': tap_gather((tp, -1)), 'v': tap_gather((tp, -1)),
                                 'map': tap_gather((tp, 1), (seq, 2))}
        return cuts

    def forward(self, x, context, cos, sin, feats=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        seq = self.seq
        cos_q, sin_q = cos, sin
        if seq is not None:
            cos_q, sin_q = seq.take(cos, 0), seq.take(sin, 0)
            if not self.is_cross:
                k, v = seq.gather(k), seq.gather(v)
        self.tap_site.put(feats, 'q', q)
        self.tap_site.put(feats, 'k', k)
        self.tap_site.put(feats, 'v', v)
        qh = self.norm_q(split_heads(q, self.heads))
        kh = self.norm_k(split_heads(k, self.heads))
        vh = split_heads(v, self.heads)
        qh = apply_rope(qh, cos_q, sin_q)
        if not self.is_cross:
            kh = apply_rope(kh, cos, sin)
        n_q = x.shape[1] if seq is None else seq.n
        store = self.store_key is not None and self.store_band[0] <= n_q <= self.store_band[1]
        if self.tap_site.wants('map') or store:
            out, probs = attention_with_probs_heads(qh, kh, vh)
            self.tap_site.put(feats, 'map', probs)
            if store and feats is not None:
                mean_p = head_mean(probs.mean(dim=1), self.tp, self.heads, self.heads_total)
                feats.setdefault(ATTN_STORE, {}).setdefault(self.store_key, []).append(
                    mean_p if seq is None else seq.gather(mean_p))
        else:
            out = attention_fused_heads(qh, kh, vh, q_len=None if seq is None else seq.n)
        return row_linear(self.to_out[0], merge_heads(out), self.tp)


class AdaLayerNormShift(nn.Module):
    """LayerNorm plus a timestep-conditioned shift (no scale)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.linear = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, temb):
        shift = self.linear(F.silu(temb.float()).to(temb.dtype))
        return self.norm(x) + shift[:, None]


class HunyuanDiTBlock(nn.Module):
    """[skip: cat([x, skip]) -> LayerNorm -> linear] -> AdaLayerNormShift
    -> self-attention -> LayerNorm -> cross-attention -> LayerNorm -> GEGLU
    MLP, with residuals; no 'out' tap (the module docstring)."""

    def __init__(self, cfg: HunyuanConfig, with_skip: bool, taps: TapSpec = EMPTY,
                 tap_name: str = '', attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        dim, eps = cfg.hidden_size, cfg.norm_eps
        if with_skip:
            self.skip_norm = nn.LayerNorm(2 * dim, eps=eps)
            self.skip_linear = nn.Linear(2 * dim, dim)
        self.with_skip = with_skip
        self.norm1 = AdaLayerNormShift(dim, eps)
        self.attn1 = HunyuanAttention(cfg, False, taps, child_id(tap_name, 'self'), attn_store)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.attn2 = HunyuanAttention(cfg, True, taps, child_id(tap_name, 'cross'), attn_store)
        self.norm3 = nn.LayerNorm(dim, eps=eps)
        self.ff = FeedForward(dim, taps=taps, tap_name=child_id(tap_name, 'ffn'),
                              inner=int(dim * cfg.mlp_ratio))

    def forward(self, x, context, temb, cos, sin, skip=None, feats=None):
        if self.with_skip:
            # the trained skip_linear takes x in the first half (diffusers)
            x = self.skip_linear(self.skip_norm(torch.cat([x, skip], dim=-1)))
        x = x + self.attn1(self.norm1(x, temb), None, cos, sin, feats)
        x = x + self.attn2(self.norm2(x), context, cos, sin, feats)
        return x + self.ff(self.norm3(x), feats=feats)


class HunyuanDiTAttentionPool(nn.Module):
    """CLIP-style attention pooling over the T5 tokens: the mean token
    prepended, a positional embedding on every token, the mean token's
    attention over all of them projected to ``output_dim``."""

    def __init__(self, seq_len: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.randn(seq_len + 1, embed_dim)
                                                 / embed_dim ** 0.5)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x):
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None].to(x.dtype)
        qh, kh, vh = (split_heads(p(t), self.num_heads)
                      for p, t in ((self.q_proj, x[:, :1]), (self.k_proj, x), (self.v_proj, x)))
        return self.c_proj(merge_heads(attention_fused_heads(qh, kh, vh)))[:, 0]


class PixArtAlphaTextProjection(nn.Module):
    """linear_1 -> SiLU in fp32 -> linear_2 (diffusers' act='silu_fp32')."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, hidden)
        self.linear_2 = nn.Linear(hidden, out_dim)

    def forward(self, x):
        h = self.linear_1(x)
        return self.linear_2(F.silu(h.float()).to(h.dtype))


class HunyuanCombinedTimestepTextSizeStyleEmbedding(nn.Module):
    def __init__(self, cfg: HunyuanConfig):
        super().__init__()
        dim = cfg.hidden_size
        self.timestep_embedder = TimestepEmbedding(256, dim)
        self.pooler = HunyuanDiTAttentionPool(cfg.text_len_t5, cfg.cross_attention_dim_t5, 8,
                                              cfg.pooled_projection_dim)
        extra = cfg.pooled_projection_dim
        if cfg.use_style_cond_and_image_meta_size:
            self.style_embedder = nn.Embedding(1, dim)
            extra += 6 * 256 + dim
        self.extra_embedder = PixArtAlphaTextProjection(extra, dim * 4, dim)


class AdaLayerNormContinuous(nn.Module):
    """The output norm: LayerNorm without affine, scaled and shifted by
    linear(silu(temb)) (scale first)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)
        self.norm = nn.LayerNorm(dim, eps=eps, elementwise_affine=False)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class HunyuanDiT2D(nn.Module):
    """forward(latents NCHW, timestep, BERT embeddings (B, 77, 1024), BERT
    mask (B, 77) or None, T5 embeddings (B, 256, 2048), T5 mask or None,
    image_meta_size (B, 6) or None, style (B,) or None, feats=None) -> the
    prediction NCHW with ``out_channels`` channels.  Requested taps land in
    ``feats``; with ``attn_store_sizes`` (min, max tokens per side) and
    ``attn_categories`` ('up_self', 'up_cross') the store's head-mean maps
    land in ``feats[layers.ATTN_STORE]``.  Sequence parallelism (the JAX
    ``token_pspec``): ``sequence_shards`` (``parallel/mesh.py``)."""

    def __init__(self, cfg: HunyuanConfig, taps: TapSpec = EMPTY,
                 attn_store_sizes: Optional[Tuple[int, int]] = None,
                 attn_categories: Sequence[str] = ()):
        super().__init__()
        self.cfg = cfg
        dim, p = cfg.hidden_size, cfg.patch_size
        store = None
        if attn_store_sizes is not None:
            store = AttnStoreCfg('up', *attn_store_sizes, frozenset(attn_categories))
        self.pos_embed = nn.Module()
        self.pos_embed.proj = nn.Conv2d(cfg.in_channels, dim, p, stride=p)
        self.time_extra_emb = HunyuanCombinedTimestepTextSizeStyleEmbedding(cfg)
        self.text_embedder = PixArtAlphaTextProjection(
            cfg.cross_attention_dim_t5, cfg.cross_attention_dim_t5 * 4, cfg.cross_attention_dim)
        self.text_embedding_padding = nn.Parameter(
            torch.randn(cfg.text_len + cfg.text_len_t5, cfg.cross_attention_dim) * 0.02)
        half = cfg.num_layers // 2
        self.blocks = nn.ModuleList([
            HunyuanDiTBlock(cfg, i > half, taps, f'vit-block{i}', store)
            for i in range(cfg.num_layers)])
        self.norm_out = AdaLayerNormContinuous(dim, cfg.norm_eps)
        self.proj_out = nn.Linear(dim, p * p * cfg.out_channels)
        self._rope = {}   # (grid, device) -> the fp32 cos, sin tables
        self.seq = self.tp = self.proj_cols = None

    def sequence_shards(self, sp):
        """Sequence parallelism over ``sp``: the blocks see this rank's
        tokens (JAX's ``token_pspec`` constraints at the block boundaries;
        the U-ViT skips are token-wise)."""
        self.seq = TokenShard(sp)
        return {'blocks': self.seq}

    def parallelize(self, tp, seq):
        """Under ``tp`` the final proj_out keeps this rank's input columns
        of its replicated input."""
        if tp is None:
            return {}
        self.tp = tp
        self.proj_cols = tp.bounds(self.proj_out.in_features)
        return {'proj_out.weight': (1, span(*self.proj_cols))}

    def rope(self, grid: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (grid^2, head_dim) fp32 RoPE tables, built once per grid and
        device: computed in float64 on the host, as in JAX."""
        key = (grid, device)
        if key not in self._rope:
            cfg = self.cfg
            self._rope[key] = tuple(torch.from_numpy(t).to(device) for t in
                                    hunyuan_rope(grid, cfg.head_dim, cfg.rope_base_size))
        return self._rope[key]

    def _conditioning(self, timestep, t5_ctx, b: int, hh: int, image_meta_size, style, dtype):
        """The timestep embedding plus the pooled-T5, image-size and style
        embedding (HunyuanDiT's combined conditioning)."""
        cfg, emb = self.cfg, self.time_extra_emb
        device = t5_ctx.device
        ts = torch.full((b,), float(timestep), dtype=torch.float32, device=device)
        temb = emb.timestep_embedder(timestep_embedding(ts, 256).to(dtype))
        extra = emb.pooler(t5_ctx)
        if cfg.use_style_cond_and_image_meta_size:
            if image_meta_size is None:
                s = float(hh * 8)
                image_meta_size = torch.tensor([[s, s, s, s, 0.0, 0.0]], device=device).repeat(b, 1)
            size_emb = timestep_embedding(image_meta_size.reshape(-1), 256).reshape(b, 6 * 256)
            style_ids = (torch.zeros(b, dtype=torch.long, device=device) if style is None
                         else style.long())
            extra = torch.cat([extra, size_emb.to(dtype), emb.style_embedder(style_ids)], dim=-1)
        return temb + emb.extra_embedder(extra)

    def forward(self, sample, timestep, encoder_hidden_states, text_embedding_mask=None,
                encoder_hidden_states_t5=None, text_embedding_mask_t5=None,
                image_meta_size=None, style=None, feats=None):
        cfg = self.cfg
        b, _, hh, ww = sample.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        dtype = self.proj_out.weight.dtype

        # 1. patchify; the 2-D RoPE tables
        x = self.pos_embed.proj(sample.to(dtype)).flatten(2).transpose(1, 2)
        cos, sin = self.rope(gh, x.device)

        # 2. the combined conditioning
        t5_ctx = encoder_hidden_states_t5.to(dtype)
        temb = self._conditioning(timestep, t5_ctx, b, hh, image_meta_size, style, dtype)

        # 3. the text context: BERT and projected T5 tokens, the learned
        #    padding row where the masks are 0
        ctx = torch.cat([encoder_hidden_states.to(dtype), self.text_embedder(t5_ctx)], dim=1)
        ones = torch.ones
        bmask = (text_embedding_mask if text_embedding_mask is not None
                 else ones((b, cfg.text_len), dtype=torch.int32, device=x.device))
        tmask = (text_embedding_mask_t5 if text_embedding_mask_t5 is not None
                 else ones((b, cfg.text_len_t5), dtype=torch.int32, device=x.device))
        keep = torch.cat([bmask, tmask], dim=1).bool()[..., None]
        ctx = torch.where(keep, ctx, self.text_embedding_padding[None].to(ctx.dtype))

        # 4. blocks: U-ViT long skips pushed in the first half, popped in the
        #    second; on this rank's tokens under sequence parallelism
        if self.seq is not None:
            x = self.seq.begin(x.shape[1]).take(x)
        skips = []
        half = cfg.num_layers // 2
        for i, blk in enumerate(self.blocks):
            x = blk(x, ctx, temb, cos, sin, skips.pop() if blk.with_skip else None, feats)
            if i < half - 1:
                skips.append(x)

        # 5. the modulated output norm, projection, unpatchify
        h = row_linear(self.proj_out, self.norm_out(x, temb), self.tp, self.proj_cols)
        if self.seq is not None:
            h = self.seq.gather(h)
        h = h.reshape(b, gh, gw, p, p, cfg.out_channels).permute(0, 5, 1, 3, 2, 4)
        return h.reshape(b, cfg.out_channels, gh * p, gw * p)
