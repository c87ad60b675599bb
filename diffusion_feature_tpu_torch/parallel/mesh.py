"""The multi-device mesh and its sharding rules (port of
``diffusion_feature_tpu/parallel/mesh.py``).

One process per rank (``torchrun --nproc_per_node N``, or processes a
caller spawns and joins with ``torch.distributed.init_process_group``).
The ranks form the JAX mesh's grid in its order, ``reshape(dp, sp, tp)``:
rank = (d * sp + s) * tp + t.  Each axis of size above 1 has its own
process group:

  dp  data parallel: each rank runs its rows of the image batch; results
      are gathered so every rank returns the whole batch (the JAX global
      array), or, in the CLIs, each rank writes its own rows.
  sp  sequence parallel: the DiTs' tokens are split between blocks (where
      JAX has ``constrain_tokens``); inside attention K and V are gathered,
      so each rank's queries meet every key.  The U-Nets have no token
      axis: their sp ranks compute the same thing, as in JAX.
  tp  tensor parallel: the denoiser's projections are cut by the rules of
      ``param_pspec`` (JAX's ``_param_pspec``, its name tables as they
      are); text encoders, VAE and ControlNets stay whole on every rank.

The backend is the caller's: NCCL between cards, gloo on the CPU and for
ranks that share one card (gloo carries CUDA tensors through the host).
The collectives are the list forms both take for CUDA tensors:
``all_gather`` into a list (pieces of uneven length are padded to the
longest and trimmed), ``all_reduce`` and ``broadcast``; on an H100 with
PyTorch 2.11, gloo also took ``all_gather_into_tensor``, which the port
does not use.

Tensor parallelism.  JAX's rules are layout hints to GSPMD, which inserts
whatever communication keeps the program equal to the unsharded one;
eager PyTorch gets no such help, so every layer the rules match is cut so
that its math holds on its own.  Column-parallel layers (to_q, to_k,
to_v, add_q_proj, add_k_proj, add_v_proj, proj, net_0_proj, proj_mlp)
keep output rows of the (out, in) weight, and their bias (and an int8
layer's per-output-channel scale) the same rows; row-parallel layers
(to_out_0, to_add_out, net_2, proj_out) keep input columns, all-reduce
their partial products, then add the whole bias once.  Only 2-D weights
are cut (``ndim == 2``, as in JAX): convolutions stay whole.  Rank r of
tp gets the r-th part of ``Axis.split``: sizes n // tp, the first n % tp
one larger, so uneven parts are allowed (SDXL's 10 heads at tp=4 give 3,
3, 2, 2).  By family, each matched layer and its cut:

  U-Net (SD-1.5, SD-2.1, SDXL, Playground; ``models/layers.py``):
    Attention to_q/to_k/to_v   output rows of whole heads (this rank's
                               heads), biases alike (the DiTs' qkv_bias)
    Attention to_out.0         input columns of the same heads
    FeedForward net.0.proj     GEGLU: matching rows of the hidden half and
                               of the gate half (rows [lo, hi) and
                               [I + lo, I + hi) of the 2I outputs, I the
                               inner width, HunyuanDiT's 6062 included);
                               GELU: rows [lo, hi)
    FeedForward net.2          input columns [lo, hi)
    Transformer2DModel proj_out (linear projection only; a 1x1 conv stays
                               whole) input columns [lo, hi) of the inner
                               width: its input is replicated, so the
                               layer slices it itself
  PixArt (``models/dit_pixart.py``): the Attention and FeedForward rows
    above; the final proj_out cut like Transformer2DModel's (replicated
    input, sliced by the layer).  pos_embed.proj is a convolution, and its
    bias stays whole with it (JAX's rule shards that bias alone; see
    ``denoiser_param_specs``); HunyuanDiT's likewise.
  HunyuanDiT (``models/hunyuan.py``): HunyuanAttention to_q/to_k/to_v and
    to_out.0 by heads (its per-head q/k norms need no cut), the GEGLU
    FeedForward, the final proj_out as PixArt's.  The T5 attention pool
    (q_proj/k_proj/v_proj/c_proj) and skip_linear match no rule.
  Flux (``models/flux.py``): the joint attention's to_q/to_k/to_v and
    add_q_proj/add_k_proj/add_v_proj by heads, to_out.0 and to_add_out
    by heads' input columns; both GELU FeedForwards (ff, ff_context); the
    single block's proj_mlp rows [lo, hi) of the MLP width and its
    proj_out, whose input is cat([attention output, MLP]), input columns
    [this rank's heads' attention columns; dim + lo .. dim + hi]; the final
    proj_out as PixArt's.  The adaLN ``linear``s, the embedders and
    norm_out match no rule.  An int8 layer is cut the same way after
    quantizing the whole weight: a row-parallel layer's scale is the
    maximum over all of K (``models/convert.load_state_into`` takes it
    across the tp group), a column-parallel one's follows its rows.
  DeepFloyd IF (``models/unet_if.py``): the added-KV attention's to_q,
    to_k, to_v, add_k_proj, add_v_proj by heads and to_out.0; the
    text-time embedding's ``proj`` (column-parallel by name) keeps output
    rows [lo, hi) and gathers them, since what follows takes them whole.

Taps come back unsharded: q/k/v gathered along features, ``map`` along
heads, an FFN ``inner`` along features in the unsharded order, and under
sp every token-indexed tap along tokens.  The attention store's head mean
on a rank is the mean over its heads, scaled by H_local / H and summed
over tp.  Gates (flash or explicit, the store's size band) see the global
sequence length, as JAX's gates see the global shapes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ('dp', 'sp', 'tp')

#: JAX's ``_param_pspec`` name tables: the layer (parent) names whose 2-D
#: kernel is cut along its output features (column) or input features (row).
COLUMN_PARALLEL = ('to_q', 'to_k', 'to_v', 'add_q_proj', 'add_k_proj', 'add_v_proj', 'proj',
                   'net_0_proj', 'proj_mlp')
ROW_PARALLEL = ('to_out_0', 'to_add_out', 'net_2', 'proj_out')

#: A cut of a tensor: (dimension, the indices kept along it).
Cut = Tuple[int, torch.Tensor]


def split_sizes(n: int, parts: int) -> List[int]:
    """The sizes of ``parts`` contiguous pieces of ``n``: n // parts each,
    the first n % parts one larger (``torch.tensor_split``'s)."""
    return [n // parts + (1 if r < n % parts else 0) for r in range(parts)]


class Axis:
    """One mesh axis as this rank sees it: its process group (None where
    the axis has one rank), this rank's coordinate and the axis size."""

    def __init__(self, name: str, group, rank: int, size: int):
        self.name, self.group, self.rank, self.size = name, group, rank, size

    def __repr__(self):
        return f'Axis({self.name!r}, rank={self.rank}, size={self.size})'

    def split(self, n: int) -> List[int]:
        return split_sizes(n, self.size)

    def bounds(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's piece of ``n``."""
        sizes = self.split(n)
        lo = sum(sizes[:self.rank])
        return lo, lo + sizes[self.rank]

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece of ``x`` along ``dim`` (a view)."""
        lo, hi = self.bounds(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    def all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``x`` over the axis in place; returns ``x``."""
        if self.size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` of the axis' rank ``src`` on every rank, in place."""
        if self.size > 1:
            dist.broadcast(x, dist.get_global_rank(self.group, src), group=self.group)
        return x

    def _sizes(self, n: int, device) -> List[int]:
        mine = torch.tensor([n], dtype=torch.int64, device=device)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        return [int(p) for p in parts]

    def gather(self, x: torch.Tensor, dim: int,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's piece of ``x`` concatenated along ``dim`` in rank
        order.  ``sizes``: the pieces' lengths along ``dim`` where the
        caller knows them; else they are exchanged first."""
        if self.size == 1:
            return x
        dim = dim % x.dim()
        if sizes is None:
            sizes = self._sizes(x.shape[dim], x.device)
        longest = max(sizes)
        x = x.contiguous()
        if x.shape[dim] < longest:
            pad = list(x.shape)
            pad[dim] = longest - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)


class _GatherWithGrad(torch.autograd.Function):
    """``Axis.gather`` whose backward is its adjoint: the gradients of the
    whole tensor summed over the axis, then this rank's piece."""

    @staticmethod
    def forward(ctx, x, axis, dim, sizes):
        ctx.axis, ctx.dim = axis, dim % x.dim()
        ctx.lo = sum(sizes[:axis.rank])
        ctx.n = x.shape[ctx.dim]
        return axis.gather(x, dim, sizes)

    @staticmethod
    def backward(ctx, grad):
        grad = ctx.axis.all_reduce(grad.contiguous().clone())
        return grad.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None


class _AllReduceWithGrad(torch.autograd.Function):
    """Sum over the axis, whose adjoint is the same sum of gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad.contiguous().clone()), None


def gather_with_grad(x: torch.Tensor, axis: Axis, dim: int, sizes: Sequence[int]):
    """``axis.gather`` that autograd differentiates (the trainer's dp)."""
    if axis.size == 1:
        return x
    return _GatherWithGrad.apply(x, axis, dim, list(sizes))


def all_reduce_with_grad(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``axis.all_reduce`` (sum) that autograd differentiates."""
    if axis.size == 1:
        return x
    return _AllReduceWithGrad.apply(x, axis)


class Mesh:
    """The (dp, sp, tp) grid of ranks: ``shape``, this rank's coordinates,
    an ``Axis`` per name (``mesh.axis('tp')``) and the process ``group`` of
    all its ranks (None: the default group)."""

    def __init__(self, shape: Mapping[str, int], coords: Mapping[str, int],
                 axes: Mapping[str, Axis], backend: str, group=None):
        self.shape, self.coords, self.axes, self.backend = dict(shape), dict(coords), dict(axes), backend
        self.group = group

    def __repr__(self):
        return (f'Mesh(dp={self.shape["dp"]}, sp={self.shape["sp"]}, tp={self.shape["tp"]}, '
                f'coords={self.coords}, backend={self.backend!r})')

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def dp(self) -> int:
        return self.shape['dp']

    @property
    def sp(self) -> int:
        return self.shape['sp']

    @property
    def tp(self) -> int:
        return self.shape['tp']

    def first_rank_object(self, obj):
        """``obj`` of the mesh's first rank (every coordinate 0) on every
        rank: the others wait for it."""
        box = [obj]
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    @property
    def writes(self) -> bool:
        """Whether this rank writes its dp row's results: sp and tp rank 0."""
        return self.coords['sp'] == 0 and self.coords['tp'] == 0


def init_launched(backend: str, device: str) -> str:
    """Join the default process group from the environment ``torchrun``
    sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), once (no-op when a
    group exists already or no launcher set the environment), and return
    this rank's device: ``cuda:<LOCAL_RANK>`` for a bare ``cuda`` where
    the launcher set LOCAL_RANK, else ``device``.  A CUDA device with an
    index becomes the current device first, so NCCL, the kernels' streams
    and every bare ``cuda`` tensor of the rank land on its card."""
    if device == 'cuda' and 'LOCAL_RANK' in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    if device.startswith('cuda:'):
        torch.cuda.set_device(device)
    if not dist.is_initialized() and 'WORLD_SIZE' in os.environ:
        dist.init_process_group(backend, init_method='env://')
    return device


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, group=None) -> Mesh:
    """The mesh of the ranks of ``group`` (default: every launched rank),
    dp x sp x tp of them in JAX's order; ``dp`` None takes what tp and sp
    leave.  Every rank of the group calls it, in the same order as any
    other mesh.  Needs an initialised default process group of at least
    that many ranks: ValueError otherwise."""
    if not (dist.is_available() and dist.is_initialized()):
        n = '<dp*sp*tp>' if dp is None else dp * sp * tp
        raise ValueError(f'make_mesh(dp={dp}, tp={tp}, sp={sp}) needs torch.distributed '
                         'initialised with one process per rank: launch with torchrun '
                         f'--nproc_per_node {n} (or call init_process_group first)')
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    n = len(ranks)
    if dp is None:
        dp = n // (tp * sp)
    if min(dp, tp, sp) < 1 or dp * sp * tp != n:
        raise ValueError(f'dp({dp}) * sp({sp}) * tp({tp}) != {n} ranks in the process group: '
                         f'launch with torchrun --nproc_per_node {dp * sp * tp}')
    me = ranks.index(dist.get_rank())
    shape = {'dp': dp, 'sp': sp, 'tp': tp}
    coords = {'dp': me // (sp * tp), 'sp': me // tp % sp, 'tp': me % tp}
    strides = {'dp': sp * tp, 'sp': tp, 'tp': 1}
    axes = {}
    for name in AXES:
        size = shape[name]
        if size == 1:
            axes[name] = Axis(name, None, 0, 1)
            continue
        base = me - coords[name] * strides[name]
        members = [ranks[base + i * strides[name]] for i in range(size)]
        if size == n:
            pg = dist.group.WORLD if group is None else group
        else:
            pg = dist.new_group(members, use_local_synchronization=True)
        axes[name] = Axis(name, pg, coords[name], size)
    return Mesh(shape, coords, axes, dist.get_backend(group), group)


def has_sp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.sp > 1


def has_tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.tp > 1


# ---------------------------------------------------------------- param rules
def param_pspec(path: Sequence[str], ndim: int) -> Tuple[Optional[str], ...]:
    """JAX's ``_param_pspec`` of a parameter at the JAX ``path`` (e.g.
    (..., 'to_q', 'kernel')) of ``ndim`` dimensions, in JAX's (in, out)
    kernel orientation: (None, 'tp') column, ('tp', None) row, ('tp',) a
    column-parallel bias or scale, () replicated."""
    name = path[-2] if len(path) >= 2 else ''
    leaf = path[-1]
    col, row = name in COLUMN_PARALLEL, name in ROW_PARALLEL
    if leaf in ('kernel', 'kernel_q') and ndim == 2:
        if col:
            return (None, 'tp')
        if row:
            return ('tp', None)
    if leaf in ('bias', 'scale') and col and ndim == 1:
        return ('tp',)
    return ()


_LEAVES = {'weight': 'kernel', 'weight_q': 'kernel_q', 'bias': 'bias', 'scale': 'scale'}


def jax_path(key: str) -> Tuple[str, ...]:
    """The JAX (parent, leaf) names of a port state-dict key: a numbered
    child joins its parent ('to_out.0.weight' -> ('to_out_0', 'kernel'))."""
    parts = key.split('.')
    leaf = _LEAVES.get(parts[-1], parts[-1])
    parent = parts[-2] if len(parts) >= 2 else ''
    if parent.isdigit() and len(parts) >= 3:
        parent = f'{parts[-3]}_{parent}'
    return parent, leaf


def denoiser_param_specs(state: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """{key: the dimension of the port tensor that tp cuts} of every
    denoiser tensor the rules match (the counterpart of JAX's
    ``denoiser_param_shardings``; the port's (out, in) weights are JAX's
    kernels transposed, so column-parallel cuts dim 0, row-parallel 1).
    One departure: the rules also shard the bias of a column-parallel name
    whose kernel is not 2-D (the DiTs' patch-embedding ``proj``
    convolution), a layout GSPMD settles by resharding; the port keeps such
    a bias whole beside its whole convolution."""
    out = {}
    for key, t in state.items():
        spec = param_pspec(jax_path(key), t.dim())
        if spec == ('tp',):
            owner = key.rpartition('.')[0]
            weight = state.get(f'{owner}.weight', state.get(f'{owner}.weight_q'))
            if weight is not None and weight.dim() == 2:
                out[key] = 0
        elif spec == (None, 'tp'):
            out[key] = 0
        elif spec == ('tp', None):
            out[key] = 1
    return out


# ----------------------------------------------------------------------- cuts
def span(lo: int, hi: int) -> torch.Tensor:
    return torch.arange(lo, hi, dtype=torch.long)


def take(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """``t``'s part under ``cut``: a view where the indices are one
    contiguous run (a checkpoint's mmap view stays unread), else a copy."""
    dim, idx = cut
    if idx.numel() and bool((idx[1:] - idx[:-1] == 1).all()):
        return t.narrow(dim, int(idx[0]), idx.numel())
    return t.index_select(dim, idx.to(t.device))


def head_rows(tp: Axis, heads: int, head_dim: int) -> Tuple[int, torch.Tensor]:
    """(this rank's head count, the rows of its heads in an (H * d)-wide
    projection)."""
    lo, hi = tp.bounds(heads)
    return hi - lo, span(lo * head_dim, hi * head_dim)


def linear_cuts(name: str, layer, dim: int, idx: torch.Tensor) -> Dict[str, Cut]:
    """The cuts of an nn.Linear or Int8Linear at ``name``: its weight
    (``weight_q``) along ``dim`` (0 keeps output rows ``idx``, 1 input
    columns); with output rows, the bias and an int8 scale too."""
    int8 = hasattr(layer, 'weight_q')
    cuts = {f'{name}.weight_q' if int8 else f'{name}.weight': (dim, idx)}
    if dim == 0:
        if layer.bias is not None:
            cuts[f'{name}.bias'] = (0, idx)
        if int8:
            cuts[f'{name}.scale'] = (0, idx)
    return cuts


def cut_heads(attn, tp: Axis, column: Sequence[str], row: Sequence[str] = ()) -> Dict[str, Cut]:
    """Cut attention module ``attn`` (``heads_total`` heads of
    ``head_dim``) to this rank's heads of ``tp``: the output rows of its
    ``column`` projections, the input columns of its ``row`` ones; sets its
    ``tp`` and its ``heads`` to the rank's count.  Returns the cuts."""
    attn.tp = tp
    attn.heads, rows = head_rows(tp, attn.heads_total, attn.head_dim)
    cuts = {}
    for dim, names in ((0, column), (1, row)):
        for name in names:
            cuts.update(linear_cuts(name, attn.get_submodule(name), dim, rows))
    return cuts


def shard_state_dict(state: Mapping[str, torch.Tensor],
                     cuts: Mapping[str, Cut]) -> Dict[str, torch.Tensor]:
    """A full state dict cut to one rank's tensors (the others as they
    are)."""
    return {k: take(t, cuts[k]) if k in cuts else t for k, t in state.items()}


def parallelize(module: torch.nn.Module, mesh: Mesh) -> Dict[str, Cut]:
    """Cut ``module`` (a denoiser, on any device, the meta device too) for
    this rank of ``mesh`` in place and return {state key: Cut} of every
    tensor cut.  Each submodule with a ``parallelize(tp, seq)`` method
    cuts its own tensors and wires its collectives; a DiT root first hands
    its blocks their token shards (``sequence_shards``).  The cut keys are
    checked against ``denoiser_param_specs``: every tensor the rules match
    is cut, and nothing else."""
    tp = mesh.axis('tp') if mesh.tp > 1 else None
    sp = mesh.axis('sp') if mesh.sp > 1 else None
    state = module.state_dict(keep_vars=True)
    seqs = module.sequence_shards(sp) if sp is not None and hasattr(
        module, 'sequence_shards') else {}
    cuts = {}
    for name, m in module.named_modules():
        if hasattr(m, 'parallelize'):
            seq = next((s for prefix, s in seqs.items()
                        if name == prefix or name.startswith(prefix + '.')), None)
            for key, cut in m.parallelize(tp, seq).items():
                cuts[f'{name}.{key}' if name else key] = cut
    if tp is not None:
        specs = denoiser_param_specs(state)
        if set(cuts) != set(specs):
            raise ValueError(f'{type(module).__name__}: tp cuts '
                             f'{sorted(set(cuts) - set(specs))[:5]} outside the rules and misses '
                             f'{sorted(set(specs) - set(cuts))[:5]}')
        for key, (dim, _) in cuts.items():
            if dim != specs[key]:
                raise ValueError(f'{key}: cut along dim {dim} against the rules')
    return cuts


def cut_parameters_(module: torch.nn.Module, cuts: Mapping[str, Cut]) -> None:
    """Replace each cut parameter or buffer of ``module`` by its part
    (shapes only where ``module`` lies on the meta device)."""
    for key, cut in cuts.items():
        owner_name, _, leaf = key.rpartition('.')
        owner = module.get_submodule(owner_name)
        old = getattr(owner, leaf)
        new = take(old.detach(), cut)
        new = new if old.device.type == 'meta' else new.clone()
        if isinstance(old, torch.nn.Parameter):
            owner._parameters[leaf] = torch.nn.Parameter(new, requires_grad=old.requires_grad)
        else:
            owner._buffers[leaf] = new


# ----------------------------------------------------------- layer helpers
def row_linear(layer, x: torch.Tensor, tp: Optional[Axis], x_cols: Optional[Tuple] = None):
    """``layer(x)`` for a row-parallel ``layer`` (nn.Linear or Int8Linear)
    holding this rank's input columns: the partial product without bias,
    summed over ``tp``, then the bias once.  ``x_cols`` (lo, hi): ``x`` is
    replicated and the layer takes its columns [lo, hi) itself.  Without
    tp: ``layer(x)``."""
    if tp is None:
        return layer(x)
    if x_cols is not None:
        x = x[..., x_cols[0]:x_cols[1]]
    if hasattr(layer, 'weight_q'):
        from ..ops.quant import int8_linear
        y = int8_linear(x, layer.weight_q, layer.scale, None)
    else:
        y = torch.nn.functional.linear(x, layer.weight)
    y = tp.all_reduce(y)
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


def head_mean(mean: torch.Tensor, tp: Optional[Axis], heads_local: int,
              heads: int) -> torch.Tensor:
    """The mean over all heads from this rank's mean over its own:
    scaled by heads_local / heads and summed over ``tp``."""
    if tp is None:
        return mean
    return tp.all_reduce(mean * (heads_local / heads))


def tap_gather(*steps):
    """A tap's gather: ``steps`` of (axis or TokenShard or None, dim),
    applied in order; None axes are skipped."""
    steps = [(a, d) for a, d in steps if a is not None]
    if not steps:
        return None

    def gather(t):
        for axis, dim in steps:
            t = axis.gather(t, dim)
        return t
    return gather


class TokenShard:
    """A DiT's token axis under sp, shared by the modules of one sequence:
    the caller sets the global length at each forward (``begin``), and
    this rank holds tokens [lo, hi) of it."""

    def __init__(self, axis: Axis):
        self.axis = axis
        self.n = self.lo = self.hi = 0

    def begin(self, n: int) -> 'TokenShard':
        self.n = n
        self.lo, self.hi = self.axis.bounds(n)
        return self

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x.narrow(dim, self.lo, self.hi - self.lo)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence of ``x``, whose ``dim`` holds this rank's
        tokens [lo, hi)."""
        return self.axis.gather(x, dim, self.axis.split(self.n))
