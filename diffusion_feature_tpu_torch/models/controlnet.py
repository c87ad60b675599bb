"""ControlNet: residual conditioning for U-Net feature extraction (port of
``diffusion_feature_tpu/models/controlnet.py``).

Each requested ControlNet preprocesses the raw image on the host (Canny
edges, or DPT depth on the device), encodes it with a copy of the U-Net's
encoder, and the per-skip residuals of several ControlNets are summed
(reference feature/components/controlnet.py:126-136); the facade adds them
to the U-Net's skips and mid block (feature/diffusion_feature.py:446-465).
Module and parameter names are diffusers' ``ControlNetModel`` keys, so a
``controlnet_{kind}`` dir loads with no renames.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..schedulers.diffusion import scalar_like
from .convert import load_safetensors_dir, load_state_into, random_module
from .unet2d import CrossAttnDownBlock2D, UNetConfig, UNetMidBlock2DCrossAttn, embed_time
from .layers import TimestepEmbedding

#: the JAX package's key for the random init of a ControlNet without weights
INIT_SEED = 7


class ControlNetConditioningEmbedding(nn.Module):
    """diffusers' conv stack from the image-space condition ([0, 1], NCHW)
    down to latent resolution: conv_in, then per stage a 3x3 conv and a
    stride-2 3x3 conv (SiLU after each), then the zero-initialised
    conv_out."""

    def __init__(self, conditioning_embedding_channels: int,
                 block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        ch = block_out_channels
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for i in range(len(ch) - 1):
            self.blocks.append(nn.Conv2d(ch[i], ch[i], 3, padding=1))
            self.blocks.append(nn.Conv2d(ch[i], ch[i + 1], 3, padding=1, stride=2))
        self.conv_out = nn.Conv2d(ch[-1], conditioning_embedding_channels, 3, padding=1)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(nn.Module):
    """The U-Net encoder copy plus zero convs (diffusers ControlNetModel
    math), built from the U-Net's own down and mid blocks, with no taps.

    forward(sample NCHW latents, timestep, encoder_hidden_states,
    controlnet_cond NCHW image-space, conditioning_scale, added_cond)
    -> (down residuals, one per U-Net skip, mid residual), all NCHW."""

    def __init__(self, cfg: UNetConfig, cond_embed_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.cfg = cfg
        self.cond_embed_channels = tuple(cond_embed_channels)
        ch0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, cfg.time_embed_dim)
        if cfg.addition_embed_type == 'text_time':
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch0, cond_embed_channels)
        self.down_blocks = nn.ModuleList()
        skip_channels = [ch0]
        ch, n_levels = ch0, len(cfg.block_out_channels)
        for level, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[level]
            last = level == n_levels - 1
            self.down_blocks.append(CrossAttnDownBlock2D(
                cfg, level, ch, out_ch, add_downsample=not last,
                has_attn=btype == 'CrossAttnDownBlock2D'))
            skip_channels += [out_ch] * (cfg.layers_per_block + (0 if last else 1))
            ch = out_ch
        self.mid_block = UNetMidBlock2DCrossAttn(cfg, cfg.block_out_channels[-1])
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skip_channels])
        self.controlnet_mid_block = nn.Conv2d(ch, ch, 1)

    def zero_convs(self):
        """The convolutions diffusers initialises to zero."""
        return [self.controlnet_cond_embedding.conv_out, *self.controlnet_down_blocks,
                self.controlnet_mid_block]

    def to_diffusers_config(self) -> dict:
        """A ``controlnet_{kind}/config.json`` for this architecture."""
        return {**self.cfg.to_diffusers_config(), '_class_name': 'ControlNetModel',
                'conditioning_embedding_out_channels': list(self.cond_embed_channels)}

    def forward(self, sample, timestep, encoder_hidden_states, controlnet_cond,
                conditioning_scale: float = 1.0, added_cond=None):
        dtype = self.conv_in.weight.dtype
        x = sample.to(dtype)
        emb = embed_time(self, self.cfg, timestep, added_cond, x)
        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(x) + self.controlnet_cond_embedding(controlnet_cond.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            x, outs = blk(x, emb, context)
            skips.extend(outs)
        x = self.mid_block(x, emb, context)
        scale = scalar_like(conditioning_scale, x)
        down = tuple(conv(s) * scale for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(x) * scale


# --------------------------------------------------------------------- host IO

def canny_edges(img: np.ndarray, low: float = 100.0, high: float = 200.0) -> np.ndarray:
    """Canny edge detector on a (H, W, 3) uint8 array -> (H, W) uint8 {0,255}.

    The JAX package's numpy stand-in for the reference's
    ``cv2.Canny(image, 100, 200)`` (feature/components/controlnet.py:31-34):
    gaussian smooth, Sobel (L1 magnitude, as cv2 defaults),
    quantized-direction non-max suppression, hysteresis thresholding.
    """
    gray = img.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114], np.float32)
    # 5x5 gaussian, sigma=1.4 (classic Canny prefilter)
    ax = np.arange(-2, 3, dtype=np.float32)
    g1 = np.exp(-ax ** 2 / (2 * 1.4 ** 2))
    g1 /= g1.sum()
    pad = np.pad(gray, 2, mode='edge')
    sm = np.apply_along_axis(lambda r: np.convolve(r, g1, 'valid'), 1, pad)
    sm = np.apply_along_axis(lambda c: np.convolve(c, g1, 'valid'), 0, sm)

    p = np.pad(sm, 1, mode='edge')
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 2 + p[:-2, 2:] - p[:-2, :-2] + p[2:, 2:] - p[2:, :-2]
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2 + p[2:, :-2] - p[:-2, :-2] + p[2:, 2:] - p[:-2, 2:]
    mag = np.abs(gx) + np.abs(gy)                      # cv2 L1 default

    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0
    q = ((ang + 22.5) // 45).astype(np.int32) % 4      # 0:E-W 1:NE 2:N-S 3:NW
    mp = np.pad(mag, 1)
    neighbors = [
        (mp[1:-1, 2:], mp[1:-1, :-2]),
        (mp[:-2, 2:], mp[2:, :-2]),
        (mp[:-2, 1:-1], mp[2:, 1:-1]),
        (mp[:-2, :-2], mp[2:, 2:]),
    ]
    n1 = np.choose(q, [a for a, _ in neighbors])
    n2 = np.choose(q, [b for _, b in neighbors])
    nms = np.where((mag >= n1) & (mag >= n2), mag, 0.0)

    strong = nms >= high
    weak = (nms >= low) & ~strong
    # hysteresis: grow from strong pixels through weak ones
    edges = strong.copy()
    frontier = strong
    for _ in range(256):
        fp = np.pad(frontier, 1)
        grown = (
            fp[:-2, :-2] | fp[:-2, 1:-1] | fp[:-2, 2:] |
            fp[1:-1, :-2] | fp[1:-1, 2:] |
            fp[2:, :-2] | fp[2:, 1:-1] | fp[2:, 2:]
        )
        new = grown & weak & ~edges
        if not new.any():
            break
        edges |= new
        frontier = new
    return (edges * 255).astype(np.uint8)


def _canny_preprocess(pil_img) -> np.ndarray:
    """PIL -> (3, H, W) float32 edge map in [0, 1], replicated to 3 channels
    (reference controlnet.py:32-34, :89-91)."""
    e = canny_edges(np.asarray(pil_img.convert('RGB'))).astype(np.float32) / 255.0
    return np.stack([e, e, e], axis=0)


class ControlNetSpec:
    """One ControlNet: its host preprocessor and its model.  ``preprocessor``
    is a callable PIL -> (3, H, W) float32 in [0, 1], or for ``'depth'`` the
    path of a transformers DPT dir; without one, ``'depth'`` takes
    ``{weights_root}/depth_estimator``."""

    def __init__(self, kind: str, unet_cfg: UNetConfig, dtype, device, preprocessor=None,
                 cond_embed_channels: Tuple[int, ...] = (16, 32, 96, 256), weights_root=None):
        self.kind = kind
        if isinstance(preprocessor, str) and kind != 'depth':
            # only the depth estimator takes a checkpoint dir; falling back
            # to the builtin preprocessor would ignore the caller's input
            raise ValueError(
                f"controlnet kind {kind!r} takes a callable preprocessor, not a path "
                f"({preprocessor!r}); paths select the depth estimator checkpoint for "
                "kind='depth'")
        if preprocessor is not None and not isinstance(preprocessor, str):
            self.preprocess = preprocessor
        elif kind in ('canny', 'canny-xl'):
            self.preprocess = _canny_preprocess
        elif kind == 'depth':
            from .depth import DPTDepthEstimator
            depth_dir = preprocessor
            if depth_dir is None and weights_root is not None:
                cand = os.path.join(weights_root, 'depth_estimator')
                depth_dir = cand if os.path.isdir(cand) else None
            if depth_dir is None:
                raise FileNotFoundError(
                    "depth controlnet needs a local depth estimator: pass "
                    "control=[('depth', '/path/to/depth_estimator')] (a transformers-DPT-format "
                    "dir), put one at {weights}/depth_estimator, or supply a callable "
                    "PIL -> (3,H,W) float32 [0,1]")
            self.preprocess = DPTDepthEstimator(depth_dir, device)
        else:
            raise NotImplementedError(f'controlnet kind {kind!r}')

        def make():
            return ControlNetModel(unet_cfg, cond_embed_channels)
        cdir = os.path.join(weights_root, f'controlnet_{kind}') if weights_root else None
        if cdir is not None and os.path.isdir(cdir):
            with torch.device('meta'):
                self.model = make()
            load_state_into(self.model, load_safetensors_dir(cdir), dtype, device)
            self.model.eval().requires_grad_(False)
        else:
            self.model = random_module(make, device, dtype,
                                       torch.Generator(device=device).manual_seed(INIT_SEED))
            with torch.no_grad():
                for conv in self.model.zero_convs():
                    conv.weight.zero_()


class IPAdapter:
    """API-parity stub: the reference declares an IPAdapter class but never
    implements or uses it (feature/components/controlnet.py:81-82)."""


def cond_embed_channels(vae_scale: int) -> Tuple[int, ...]:
    """The conditioning stack that downsamples image space by ``vae_scale``:
    the stock (16, 32, 96, 256) for the SD VAEs' 8x, else 16 then doubling
    widths from 32, one stride-2 stage per factor of 2."""
    n_stages = max(1, (vae_scale - 1).bit_length())
    return ((16, 32, 96, 256) if n_stages == 3
            else tuple([16] + [32 * 2 ** i for i in range(n_stages)]))


class ControlNetPipeline:
    """The facade's ControlNets (reference ControlNetPipeline,
    feature/components/controlnet.py:87-136): preprocessing on the host,
    each net's forward and the sum of their residuals in ``encode_all``.
    ``choices`` are kinds ('canny', 'depth') or (kind, preprocessor) pairs;
    each net's weights come from ``{weights_root}/controlnet_{kind}`` when
    that dir exists, else from a random init whose zero convs are zero."""

    def __init__(self, extractor, choices: Sequence, weights_root=None):
        self.dtype = extractor.dtype
        self.device = extractor.device
        self.img_size = extractor.img_size
        channels = cond_embed_channels(extractor.vae_scale)
        self.nets = []
        for c in choices:
            kind, pre = c if isinstance(c, tuple) else (c, None)
            self.nets.append(ControlNetSpec(kind, extractor.spec.unet, self.dtype, self.device,
                                            pre, channels, weights_root))

    def prepare_control_images(self, raw_images, batch_size: int):
        """PIL images (or uint8 arrays) -> one (B, 3, S, S) tensor per net:
        resized to the extraction size (PIL bilinear), preprocessed, one
        image repeated over the batch."""
        from PIL import Image
        out = []
        for net in self.nets:
            conds = []
            for im in raw_images:
                if not hasattr(im, 'convert'):
                    im = Image.fromarray(np.asarray(im, np.uint8))
                im = im.resize((self.img_size, self.img_size), Image.BILINEAR)
                conds.append(net.preprocess(im))
            arr = np.stack(conds)
            if arr.shape[0] == 1 and batch_size > 1:
                arr = np.repeat(arr, batch_size, axis=0)
            out.append(torch.from_numpy(arr).to(self.device, self.dtype))
        return tuple(out)

    def tensors_to_pil(self, tensors):
        """Images in [-1, 1] (B, 3, H, W) -> PIL images, in the tensors'
        dtype before the uint8 cast, as the JAX package rounds."""
        from PIL import Image
        arr = ((tensors + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        return [Image.fromarray(a.transpose(1, 2, 0)) for a in arr]

    def encode_all(self, latents, t, prompt_embeds, conds, added_cond=None):
        """Every net's residuals, summed over the nets (reference
        :126-136)."""
        down_sum = mid_sum = None
        for net, cond in zip(self.nets, conds):
            down, mid = net.model(latents, t, prompt_embeds, cond, 1.0, added_cond)
            if down_sum is None:
                down_sum, mid_sum = list(down), mid
            else:
                down_sum = [a + b for a, b in zip(down_sum, down)]
                mid_sum = mid_sum + mid
        return tuple(down_sum), mid_sum
