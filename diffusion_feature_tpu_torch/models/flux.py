"""Flux.1-dev transformer with activation taps (port of
``diffusion_feature_tpu/models/flux.py``), with diffusers'
``FluxTransformer2DModel`` key names (``x_embedder``,
``time_text_embed.{timestep,guidance,text}_embedder.linear_{1,2}``,
``context_embedder``, ``transformer_blocks.N.{norm1,norm1_context}.linear``,
``.attn.{to_q,to_k,to_v,norm_q,norm_k,add_q_proj,add_k_proj,add_v_proj,
norm_added_q,norm_added_k,to_out.0,to_add_out}``, ``.ff.net.{0.proj,2}``,
``.ff_context.net.{0.proj,2}``, ``single_transformer_blocks.N.{norm.linear,
proj_mlp,proj_out,attn.*}``, ``norm_out.linear``, ``proj_out``), so a
``transformer/`` dir loads with no renames.

19 dual-stream (MMDiT) blocks attend jointly over [text; image] tokens,
each stream with its own projections, adaLN-Zero modulation and MLP; 38
single-stream blocks run attention and the MLP in parallel over the joint
sequence.  q and k take a per-head RMSNorm, then RoPE over three position
axes (text tokens at 0, image tokens at their packed row and column).  The
timestep, the guidance scale (guidance-distilled .1-dev) and the CLIP
pooled vector make the modulation's embedding; the T5 sequence is the text
stream.  The latents come 2x2-packed (``pack_latents``).

Taps (reference feature_extractor.py:98-123): dual blocks are
``vit-block{0..18}``, single blocks continue the index.  Dual:
``-q/-k/-v`` (the image stream's projections), ``-cross-map`` (image rows
x text columns) and ``-self-map`` of the joint probabilities,
``-attn-out`` (the image output after ``to_out.0``), ``-norm-out`` (the
modulated norm before the MLP), ``-ffn-inner`` and ``-out``, which, as in
the reference, gathers the same modulated norm and not the block's output.
Single: ``-q/-k/-v``, ``-attn-out`` (before the projection) and ``-out``,
each sliced to the image rows.  Attention goes to the flash kernel (B1)
where the gate admits it (4608 joint tokens of 24 heads x 128 at 1024²);
a ``-map`` tap or the attention store (place ``'up'``) makes it explicit,
as the JAX package does (no B2/B3 here).  With ``quantize_int8`` the
projections the JAX package quantizes (its ``_dense``: every block's q/k/v,
output and MLP projections, the adaLN modulations and the context
embedder) are ``ops/quant.Int8Linear`` (the W8A16 kernel on the card); the
taps read the same tensors.
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
from ..ops.quant import linear_factory
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel.mesh import (TokenShard, cut_heads, head_mean, head_rows, linear_cuts,
                             row_linear, span, tap_gather)
from ..taps import EMPTY, TapSite, TapSpec, child_id
from .hunyuan import AdaLayerNormContinuous
from .layers import ATTN_STORE, AttnStoreCfg, FeedForward, TimestepEmbedding, timestep_embedding


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64                  # 2x2-packed 16-channel latents
    num_layers: int = 19                   # dual-stream (MMDiT) blocks
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096        # T5-XXL width
    pooled_projection_dim: int = 768       # CLIP-L pooled width
    guidance_embeds: bool = True           # .1-dev is guidance-distilled
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    mlp_ratio: float = 4.0
    # int8 weight-only projections (ops/quant.py), the JAX package's
    # quantize_int8: every block projection, the adaLN modulations and the
    # context embedder; the embedders, norm_out and proj_out stay full
    # precision.  The facade sets it (the JAX auto rule); a checkpoint's
    # config.json never carries it
    quantize_int8: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @staticmethod
    def from_diffusers_config(d: dict) -> 'FluxConfig':
        """Adapt a diffusers transformer config.json, as the JAX package
        does (missing keys take Flux.1-dev's values)."""
        return FluxConfig(
            in_channels=d.get('in_channels', 64),
            num_layers=d.get('num_layers', 19),
            num_single_layers=d.get('num_single_layers', 38),
            attention_head_dim=d.get('attention_head_dim', 128),
            num_attention_heads=d.get('num_attention_heads', 24),
            joint_attention_dim=d.get('joint_attention_dim', 4096),
            pooled_projection_dim=d.get('pooled_projection_dim', 768),
            guidance_embeds=d.get('guidance_embeds', True),
            axes_dims_rope=tuple(d.get('axes_dims_rope', (16, 56, 56))),
        )

    def to_diffusers_config(self) -> dict:
        fields = dataclasses.asdict(self)
        del fields['mlp_ratio']   # diffusers' Flux has none: always 4
        del fields['quantize_int8']
        return {'_class_name': 'FluxTransformer2DModel', 'patch_size': 1, **fields,
                'axes_dims_rope': list(self.axes_dims_rope)}


FLUX_DEV = FluxConfig()


def tiny_flux_config() -> FluxConfig:
    return FluxConfig(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=8,
                      num_attention_heads=2, joint_attention_dim=32, pooled_projection_dim=32,
                      axes_dims_rope=(2, 2, 4))


# ------------------------------------------------------------------ packing
def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2 * W/2, 4C): Flux's 2x2 patch packing
    (FluxPipeline._pack_latents)."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H/2 * W/2, 4C) -> (B, C, H, W)."""
    b, _, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def make_img_ids(h: int, w: int) -> np.ndarray:
    """(h/2 * w/2, 3) position ids of the packed latents: [:, 1] the row,
    [:, 2] the column (FluxPipeline._prepare_latent_image_ids)."""
    ids = np.zeros((h // 2, w // 2, 3), np.float32)
    ids[..., 1] = np.arange(h // 2, dtype=np.float32)[:, None]
    ids[..., 2] = np.arange(w // 2, dtype=np.float32)[None, :]
    return ids.reshape(-1, 3)


class RMSNorm(nn.Module):
    """diffusers' RMSNorm: the mean square in fp32, eps inside the square
    root, the reciprocal root cast to x's dtype before the multiply."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return x * self.weight.to(x.dtype)


class _Modulation(nn.Module):
    """adaLN's projection of silu(temb) into ``n`` chunks of ``dim``
    (diffusers' ``AdaLayerNormZero``/``AdaLayerNormZeroSingle`` ``.linear``;
    their LayerNorm has no parameters)."""

    def __init__(self, dim: int, n: int, linear=nn.Linear):
        super().__init__()
        self.linear = linear(dim, n * dim)
        self.n = n

    def forward(self, silu_temb):
        return [m[:, None] for m in self.linear(silu_temb).chunk(self.n, dim=-1)]


def _layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class _AttentionTaps(nn.Module):
    """The q/k/v projections with their per-head RMSNorms, and the
    attention over the joint sequence: explicit (keeping the cross and
    self maps of the image rows) where a ``-map`` tap or the store wants
    the probabilities, else the fused path."""

    def __init__(self, cfg: FluxConfig, taps: TapSpec, tap_name: str,
                 attn_store: Optional[AttnStoreCfg], feats: Sequence[str]):
        super().__init__()
        inner = cfg.inner_dim
        self.heads = cfg.num_attention_heads
        linear = linear_factory(cfg.quantize_int8)
        self.to_q, self.to_k, self.to_v = (linear(inner, inner) for _ in range(3))
        self.norm_q = RMSNorm(cfg.attention_head_dim)
        self.norm_k = RMSNorm(cfg.attention_head_dim)
        self.tap_site = TapSite(taps, tap_name, feats)
        self.store = [(None, None), (None, None)]
        if attn_store is not None:
            self.store = [attn_store.slot(True), attn_store.slot(False)]
        self.heads_total, self.head_dim = self.heads, cfg.attention_head_dim
        self.tp = self.seq = None

    def _parallelize(self, tp, seq, column, row=()):
        """This rank's heads of ``tp`` (``column`` projections' rows,
        ``row`` ones' columns) and its tokens of ``seq``; returns the cuts.
        The taps' image rows of a rank have lengths of their own, which the
        gathers exchange."""
        cuts = {} if tp is None else cut_heads(self, tp, column, row)
        self.seq = seq
        tokens = None if seq is None else seq.axis
        self.tap_site.gathers = {
            'q': tap_gather((tokens, 1), (tp, -1)),
            'k': tap_gather((tp, -1)), 'v': tap_gather((tp, -1)),
            'cross-map': tap_gather((tp, 1), (tokens, 2)),
            'self-map': tap_gather((tp, 1), (tokens, 2))}
        return cuts

    def heads_of(self, x, feats=None, q_from: int = 0, kv_from: int = 0):
        """(qh, kh, vh) of ``x`` (this rank's tokens under sp) with q and k
        RMS-normed, K and V of the whole sequence; the taps take q's rows
        from ``q_from`` on and K's and V's from ``kv_from`` on."""
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.seq is not None:
            k, v = self.seq.gather(k), self.seq.gather(v)
        self.tap_site.put(feats, 'q', q[:, q_from:])
        self.tap_site.put(feats, 'k', k[:, kv_from:])
        self.tap_site.put(feats, 'v', v[:, kv_from:])
        qh, kh, vh = (split_heads(t, self.heads) for t in (q, k, v))
        return self.norm_q(qh), self.norm_k(kh), vh

    def attend(self, qh, kh, vh, text_len: int, feats=None, image_from: Optional[int] = None):
        """Attention over the joint (B, H, text + image, D) heads; the
        image queries start at row ``image_from`` of ``qh`` (``text_len``
        where None; under sp qh holds this rank's queries, kh all keys)."""
        image_from = text_len if image_from is None else image_from
        img_len = kh.shape[2] - text_len
        store = [key for key, band in self.store
                 if key is not None and band[0] <= img_len <= band[1]]
        if self.tap_site.wants('cross-map') or self.tap_site.wants('self-map') or store:
            out, probs = attention_with_probs_heads(qh, kh, vh)
            cross = probs[:, :, image_from:, :text_len]
            self_ = probs[:, :, image_from:, text_len:]
            self.tap_site.put(feats, 'cross-map', cross)
            self.tap_site.put(feats, 'self-map', self_)
            if feats is not None:
                for key in store:
                    maps = cross if key.endswith('_cross') else self_
                    mean_p = head_mean(maps.mean(dim=1), self.tp, self.heads, self.heads_total)
                    if self.seq is not None:
                        mean_p = self.seq.axis.gather(mean_p, 1)
                    feats.setdefault(ATTN_STORE, {}).setdefault(key, []).append(mean_p)
            return out
        return attention_fused_heads(qh, kh, vh,
                                     q_len=None if self.seq is None else kh.shape[2])


class FluxJointAttention(_AttentionTaps):
    """Dual-stream joint attention: the image and text streams' own
    projections, joined as [text; image] and rotated after the join;
    returns (image output, text output), each through its projection."""

    def __init__(self, cfg: FluxConfig, taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__(cfg, taps, tap_name, attn_store,
                         ('q', 'k', 'v', 'cross-map', 'self-map', 'attn-out'))
        inner = cfg.inner_dim
        linear = linear_factory(cfg.quantize_int8)
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (linear(inner, inner)
                                                             for _ in range(3))
        self.norm_added_q = RMSNorm(cfg.attention_head_dim)
        self.norm_added_k = RMSNorm(cfg.attention_head_dim)
        self.to_out = nn.ModuleList([linear(inner, inner)])
        self.to_add_out = linear(inner, inner)

    def parallelize(self, tp, seq):
        """This rank's heads of both streams' projections, to_out.0's and
        to_add_out's columns of them; the image tokens of ``seq``."""
        cuts = self._parallelize(tp, seq, ('to_q', 'to_k', 'to_v', 'add_q_proj', 'add_k_proj',
                                           'add_v_proj'), ('to_out.0', 'to_add_out'))
        self.tap_site.gathers['attn-out'] = tap_gather((seq, 1))
        return cuts

    def forward(self, img, ctx, cos, sin, feats=None, q_rope=None):
        """``q_rope``: the (cos, sin) rows of this rank's queries under sp
        (text, then its image tokens); (cos, sin) where None."""
        qh, kh, vh = self.heads_of(img, feats=feats)
        cq, ck, cv = (split_heads(p(ctx), self.heads)
                      for p in (self.add_q_proj, self.add_k_proj, self.add_v_proj))
        cq, ck = self.norm_added_q(cq), self.norm_added_k(ck)
        text_len = ctx.shape[1]
        qj = apply_rope(torch.cat([cq, qh], dim=2), *(q_rope or (cos, sin)))
        kj = apply_rope(torch.cat([ck, kh], dim=2), cos, sin)
        vj = torch.cat([cv, vh], dim=2)
        out = merge_heads(self.attend(qj, kj, vj, text_len, feats))
        img_out = row_linear(self.to_out[0], out[:, text_len:], self.tp)
        self.tap_site.put(feats, 'attn-out', img_out)
        return img_out, row_linear(self.to_add_out, out[:, :text_len], self.tp)


class FluxSingleAttention(_AttentionTaps):
    """Single-stream attention over the joint sequence; returns the merged
    heads without a projection (the block projects them with the MLP)."""

    def __init__(self, cfg: FluxConfig, taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__(cfg, taps, tap_name, attn_store,
                         ('q', 'k', 'v', 'cross-map', 'self-map', 'attn-out'))

    def parallelize(self, tp, seq):
        """This rank's heads of to_q/to_k/to_v and its joint tokens of
        ``seq``; 'attn-out' (before the block's projection) is gathered
        along tokens and heads."""
        cuts = self._parallelize(tp, seq, ('to_q', 'to_k', 'to_v'))
        tokens = None if seq is None else seq.axis
        self.tap_site.gathers['attn-out'] = tap_gather((tokens, 1), (tp, -1))
        return cuts

    def forward(self, x, text_len: int, cos, sin, feats=None, q_rope=None):
        """``x``: the joint sequence (this rank's rows of it under sp, from
        ``seq.lo``, and ``q_rope`` their (cos, sin) rows)."""
        image_from = text_len if self.seq is None else max(text_len - self.seq.lo, 0)
        qh, kh, vh = self.heads_of(x, feats, image_from, text_len)
        qh, kh = apply_rope(qh, *(q_rope or (cos, sin))), apply_rope(kh, cos, sin)
        out = merge_heads(self.attend(qh, kh, vh, text_len, feats, image_from))
        self.tap_site.put(feats, 'attn-out', out[:, image_from:])
        return out


class FluxTransformerBlock(nn.Module):
    """Dual-stream MMDiT block; taps ``-norm-out`` and ``-out`` (the same
    modulated norm: the reference's quirk, transformer_flux.py:210-211)."""

    def __init__(self, cfg: FluxConfig, taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        dim = cfg.inner_dim
        mlp = int(dim * cfg.mlp_ratio)
        linear = linear_factory(cfg.quantize_int8)
        self.norm1 = _Modulation(dim, 6, linear)
        self.norm1_context = _Modulation(dim, 6, linear)
        self.attn = FluxJointAttention(cfg, taps, tap_name, attn_store)
        self.ff = FeedForward(dim, taps, child_id(tap_name, 'ffn'), 'gelu-approximate', mlp,
                              linear)
        self.ff_context = FeedForward(dim, activation_fn='gelu-approximate', inner=mlp,
                                      linear=linear)
        self.ff_context.tap_site = TapSite(EMPTY, '', ())   # the text stream's MLP has no taps
        self.tap_site = TapSite(taps, tap_name, ('norm-out', 'out'))

    def parallelize(self, tp, seq):
        self.tap_site.gathers = {'norm-out': tap_gather((seq, 1)), 'out': tap_gather((seq, 1))}
        return {}

    def forward(self, img, ctx, temb, cos, sin, feats=None, q_rope=None):
        silu_t = F.silu(temb)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = self.norm1(silu_t)
        csh_msa, csc_msa, cg_msa, csh_mlp, csc_mlp, cg_mlp = self.norm1_context(silu_t)
        attn_out, ctx_attn_out = self.attn(_layer_norm(img) * (1 + sc_msa) + sh_msa,
                                           _layer_norm(ctx) * (1 + csc_msa) + csh_msa,
                                           cos, sin, feats, q_rope)
        img = img + g_msa * attn_out
        norm_h = _layer_norm(img) * (1 + sc_mlp) + sh_mlp
        self.tap_site.put(feats, 'norm-out', norm_h)
        img = img + g_mlp * self.ff(norm_h, feats=feats)
        self.tap_site.put(feats, 'out', norm_h)
        ctx = ctx + cg_msa * ctx_attn_out
        ctx = ctx + cg_mlp * self.ff_context(_layer_norm(ctx) * (1 + csc_mlp) + csh_mlp)
        return img, ctx


class FluxSingleTransformerBlock(nn.Module):
    """Single-stream block: attention and the MLP in parallel on the
    modulated norm, one projection of both; tap ``-out``, the block's
    output at the image rows."""

    def __init__(self, cfg: FluxConfig, taps: TapSpec = EMPTY, tap_name: str = '',
                 attn_store: Optional[AttnStoreCfg] = None):
        super().__init__()
        dim = cfg.inner_dim
        mlp = int(dim * cfg.mlp_ratio)
        linear = linear_factory(cfg.quantize_int8)
        self.norm = _Modulation(dim, 3, linear)
        self.proj_mlp = linear(dim, mlp)
        self.attn = FluxSingleAttention(cfg, taps, tap_name, attn_store)
        self.proj_out = linear(dim + mlp, dim)
        self.mlp_width = mlp
        self.tap_site = TapSite(taps, tap_name, ('out',))
        self.tp = self.seq = None

    def parallelize(self, tp, seq):
        """Under ``tp`` proj_mlp keeps rows [lo, hi) of the MLP width and
        proj_out the input columns of this rank's attention heads and of
        those MLP rows; 'out' is gathered along ``seq``'s tokens."""
        self.seq = seq
        self.tap_site.gathers = {'out': tap_gather((None if seq is None else seq.axis, 1))}
        if tp is None:
            return {}
        self.tp = tp
        part = span(*tp.bounds(self.mlp_width))
        _, heads = head_rows(tp, self.attn.heads_total, self.attn.head_dim)
        dim = self.attn.heads_total * self.attn.head_dim
        return {**linear_cuts('proj_mlp', self.proj_mlp, 0, part),
                **linear_cuts('proj_out', self.proj_out, 1, torch.cat([heads, dim + part]))}

    def forward(self, x, text_len: int, temb, cos, sin, feats=None, q_rope=None):
        shift, scale, gate = self.norm(F.silu(temb))
        norm_x = _layer_norm(x) * (1 + scale) + shift
        mlp = F.gelu(self.proj_mlp(norm_x), approximate='tanh')
        attn_out = self.attn(norm_x, text_len, cos, sin, feats, q_rope)
        x = x + gate * row_linear(self.proj_out, torch.cat([attn_out, mlp], dim=-1), self.tp)
        image_from = text_len if self.seq is None else max(text_len - self.seq.lo, 0)
        self.tap_site.put(feats, 'out', x[:, image_from:])
        return x


class _TextProjection(nn.Module):
    """linear_1 -> SiLU -> linear_2 (diffusers' PixArtAlphaTextProjection,
    act 'silu')."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class FluxTransformer2D(nn.Module):
    """forward(packed latents (B, S_img, in_channels), timestep in [0,
    1000], T5 embeddings (B, L, 4096), CLIP pooled (B, 768), guidance in
    [0, 1000] or None (1000), the packed grid (rows, columns), feats=None)
    -> the packed prediction (B, S_img, in_channels).  Requested taps land
    in ``feats``; with ``attn_store_sizes`` (min, max tokens per side) and
    ``attn_categories`` ('up_self', 'up_cross') the store's head-mean maps
    land in ``feats[layers.ATTN_STORE]``.  Sequence parallelism (the JAX
    ``token_pspec``): ``sequence_shards`` (``parallel/mesh.py``)."""

    def __init__(self, cfg: FluxConfig, taps: TapSpec = EMPTY,
                 attn_store_sizes: Optional[Tuple[int, int]] = None,
                 attn_categories: Sequence[str] = ()):
        super().__init__()
        self.cfg = cfg
        dim = cfg.inner_dim
        store = None
        if attn_store_sizes is not None:
            store = AttnStoreCfg('up', *attn_store_sizes, frozenset(attn_categories))
        self.x_embedder = nn.Linear(cfg.in_channels, dim)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = TimestepEmbedding(256, dim)
        if cfg.guidance_embeds:
            self.time_text_embed.guidance_embedder = TimestepEmbedding(256, dim)
        self.time_text_embed.text_embedder = _TextProjection(cfg.pooled_projection_dim, dim)
        self.context_embedder = linear_factory(cfg.quantize_int8)(cfg.joint_attention_dim, dim)
        self.transformer_blocks = nn.ModuleList([
            FluxTransformerBlock(cfg, taps, f'vit-block{i}', store)
            for i in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList([
            FluxSingleTransformerBlock(cfg, taps, f'vit-block{cfg.num_layers + j}', store)
            for j in range(cfg.num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(dim, 1e-6)
        self.proj_out = nn.Linear(dim, cfg.in_channels)
        # (grid, text_len, device, inference mode) -> the fp32 cos, sin tables
        self._rope = {}
        self.img_seq = self.joint_seq = self.tp = self.proj_cols = None

    def sequence_shards(self, sp):
        """Sequence parallelism over ``sp`` (JAX's ``token_pspec``
        constraints): the dual blocks split the image tokens (the text
        stream stays whole on every rank), the single blocks the joint
        [text; image] sequence."""
        self.img_seq, self.joint_seq = TokenShard(sp), TokenShard(sp)
        return {'transformer_blocks': self.img_seq,
                'single_transformer_blocks': self.joint_seq}

    def parallelize(self, tp, seq):
        """Under ``tp`` the final proj_out keeps this rank's input columns
        of its replicated input."""
        if tp is None:
            return {}
        self.tp = tp
        self.proj_cols = tp.bounds(self.proj_out.in_features)
        return {'proj_out.weight': (1, span(*self.proj_cols))}

    def rope(self, grid_hw: Tuple[int, int], text_len: int, device):
        """The ((text_len + rows * cols), head_dim) fp32 RoPE tables of the
        joint sequence, built once per grid and device: the text tokens at
        position 0, the image tokens at (0, row, col), in float64 on the
        host, as in JAX.  Tables made under inference mode are kept apart:
        autograd (prompt tuning after an extract) cannot save them."""
        key = (tuple(grid_hw), text_len, device, torch.is_inference_mode_enabled())
        if key not in self._rope:
            gh, gw = grid_hw
            ids = np.concatenate([np.zeros((text_len, 3), np.float32),
                                  make_img_ids(gh * 2, gw * 2)], axis=0)
            self._rope[key] = tuple(torch.from_numpy(t).to(device)
                                    for t in rope_cos_sin(ids, self.cfg.axes_dims_rope))
        return self._rope[key]

    def forward(self, hidden_states, timestep, encoder_hidden_states, pooled_projections,
                guidance=None, grid_hw: Optional[Tuple[int, int]] = None, feats=None):
        cfg, emb = self.cfg, self.time_text_embed
        b, s_img, _ = hidden_states.shape
        dtype = self.proj_out.weight.dtype
        if grid_hw is None:
            side = int(round(s_img ** 0.5))
            grid_hw = (side, side)

        x = self.x_embedder(hidden_states.to(dtype))
        device = x.device
        ts = torch.full((b,), float(timestep), dtype=torch.float32, device=device)
        temb = emb.timestep_embedder(timestep_embedding(ts, 256).to(dtype))
        if cfg.guidance_embeds:
            g = torch.full((b,), 1000.0 if guidance is None else float(guidance),
                           dtype=torch.float32, device=device)
            temb = temb + emb.guidance_embedder(timestep_embedding(g, 256).to(dtype))
        temb = temb + emb.text_embedder(pooled_projections.to(dtype))
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        text_len = ctx.shape[1]
        cos, sin = self.rope(grid_hw, text_len, device)

        q_rope = None
        if self.img_seq is not None:
            seq = self.img_seq.begin(s_img)
            x = seq.take(x)
            q_rope = tuple(torch.cat([t[:text_len], t[text_len + seq.lo:text_len + seq.hi]])
                           for t in (cos, sin))
        for blk in self.transformer_blocks:
            x, ctx = blk(x, ctx, temb, cos, sin, feats, q_rope)
        if self.img_seq is not None:
            x = self.img_seq.gather(x)
        h = torch.cat([ctx, x], dim=1)
        if self.joint_seq is not None:
            seq = self.joint_seq.begin(h.shape[1])
            h = seq.take(h)
            q_rope = (seq.take(cos, 0), seq.take(sin, 0))
        for blk in self.single_transformer_blocks:
            h = blk(h, text_len, temb, cos, sin, feats, q_rope)
        if self.joint_seq is not None:
            h = self.joint_seq.gather(h)
        return row_linear(self.proj_out, self.norm_out(h[:, text_len:], temb), self.tp,
                          self.proj_cols)
