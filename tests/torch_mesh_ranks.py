"""The rank processes of tests/test_torch_mesh.py: one world of 4 gloo
ranks on the CPU that runs every mesh case of the port, each against the
unsharded port, and hands the results back as numpy files.

This module imports no JAX (the children would pay for it and gain
nothing); the test module compares with the JAX package in the parent.
``spawn_world(root)`` starts the ranks; each case writes
``{root}/{case}.r{rank}.npz`` (or ``.err`` with the traceback) and then
``.done``.  The cases that compare with JAX wait for ``{root}/jax/ready``,
which the parent writes once it has put the JAX facades' weights, prompt
embeddings and noise there.
"""

import datetime
import json
import os
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

WORLD = 4
SIZE = 64
SEG_CLASSES = 5
#: The layers of the dp2 x tp2 test-sd case (JAX's too).
SD_LAYERS = {'up-level1-repeat0-res-out': True, 'up-level1-repeat0-vit-block0-self-q': True,
             'up-level1-repeat0-vit-block0-self-map': True,
             'up-level1-repeat0-vit-block0-ffn-inner': True, 'mid-vit-block0-out': True}
SD_STORE = dict(attention=['up_self', 'up_cross'], attn_store_sizes=(16, 32))
#: The layers of the dp2 x sp2 test-flux case (JAX's too).
FLUX_LAYERS = {'vit-block0-out': True, 'vit-block2-out': True, 'vit-block0-q': True,
               'vit-block2-q': True, 'vit-block1-self-map': True, 'vit-block3-attn-out': True}


def make_image(seed=0, size=80):
    rng = np.random.RandomState(seed)
    return Image.fromarray((rng.rand(size, size, 3) * 255).astype('uint8'))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn_world(root, world: int = WORLD):
    """Start ``world`` rank processes running every case into ``root``."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=run, args=(rank, world, port, str(root)), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def wait_for(path: Path, timeout: float):
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f'{path} did not appear within {timeout} s')
        time.sleep(0.05)


# ------------------------------------------------------------------ helpers
def _fe(version, layer, mesh=None, **kw):
    from diffusion_feature_tpu_torch import FeatureExtractor
    fe = FeatureExtractor(layer, version, device='cpu', dtype='float32', img_size=SIZE,
                          mesh=mesh, seed=0, **kw)
    fe.feature_dtype = None   # fp32 features, as JAX's mesh tests compare them
    return fe


def _np(feats):
    return {k: v.float().numpy() for k, v in feats.items()}


def _prefixed(prefix, arrays):
    return {f'{prefix}/{k}': v for k, v in arrays.items()}


def _jax_inputs(root, name):
    """The parent's JAX-side inputs of case ``name``: its weights dir, its
    prompt embeddings (a tuple, None where absent) and its noise pair."""
    jax_dir = Path(root) / 'jax'
    wait_for(jax_dir / 'ready', 300)
    z = np.load(jax_dir / f'{name}.npz')
    prompts = tuple(torch.from_numpy(z[f'prompt{i}']) if f'prompt{i}' in z else None
                    for i in range(4))
    noise = (torch.from_numpy(z['posterior']), torch.from_numpy(z['noise']))
    return str(jax_dir / name), prompts, noise


def _with_noise(fe, noise):
    fe._latent_noise = lambda batch_size: noise
    return fe


def _held(denoiser):
    """(tokens of the last forward this rank held, of all; heads of the
    first block's attention it holds, of all), the mesh's cut seen from
    inside the model."""
    seq = getattr(denoiser, 'seq', None) or getattr(denoiser, 'img_seq', None)
    tokens = (seq.hi - seq.lo, seq.n) if seq is not None else (0, 0)
    attn = next(m for m in denoiser.modules() if hasattr(m, 'heads_total'))
    return np.array([*tokens, attn.heads, attn.heads_total])


def _pair_group(rank):
    """The 2-rank group of ranks {0, 1} or {2, 3}: the cases that need a
    launched group of two run on both pairs at once."""
    pair = [0, 1] if rank < 2 else [2, 3]
    return pair, dist.new_group(pair, use_local_synchronization=True)


# -------------------------------------------------------------------- cases
def case_dp4_sd(rank, root):
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    layer = {'up-level1-repeat0-res-out': True}
    out = {}
    fe = _fe('test-sd', layer, make_mesh(dp=4))
    imgs = [make_image(i) for i in range(4)]
    out.update(_prefixed('mesh', _np(fe.extract(fe.encode_prompt('a cat'), 4, imgs, t=50))))
    if rank == 0:
        plain = _fe('test-sd', layer)
        out.update(_prefixed('plain', _np(plain.extract(plain.encode_prompt('a cat'), 4, imgs,
                                                        t=50))))
    return out


def _jax_case(rank, root, name, version, layers, mesh_kw, t, fe_kw):
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    weights, prompts, noise = _jax_inputs(root, name)
    imgs = [make_image(i) for i in range(4)]
    out = {}
    fe = _with_noise(_fe(version, layers, make_mesh(**mesh_kw), weights=weights, **fe_kw), noise)
    prompt_in = prompts if version != 'test-flux' else (prompts[0], None, prompts[2], None)
    out.update(_prefixed('mesh', _np(fe.extract(prompt_in, 4, imgs, t=t))))
    out['held'] = _held(fe.unet)
    if rank == 0:
        plain = _with_noise(_fe(version, layers, weights=weights, **fe_kw), noise)
        out.update(_prefixed('plain', _np(plain.extract(prompt_in, 4, imgs, t=t))))
    return out


def case_dp2_tp2_sd(rank, root):
    return _jax_case(rank, root, 'dp2_tp2_sd', 'test-sd', SD_LAYERS, dict(dp=2, tp=2), 50,
                     SD_STORE)


def case_dp2_sp2_flux(rank, root):
    return _jax_case(rank, root, 'dp2_sp2_flux', 'test-flux', FLUX_LAYERS, dict(dp=2, sp=2),
                     500, dict(transformer_8bit=False, t5_8bit=False))


def _dit_case(rank, version, layers, mesh_kw, batch, store, prompt='a cat'):
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    kw = dict(attention=['up_self', 'up_cross'], attn_store_sizes=(8, 16)) if store else {}
    imgs = [make_image(i) for i in range(batch)]
    out = {}
    for tag, mesh in (('mesh', make_mesh(**mesh_kw)), ('plain', None)):
        if tag == 'plain' and rank != 0:
            break
        fe = _fe(version, layers, mesh, **kw)
        p = fe.encode_prompt(prompt) if version == 'test-pixart' else prompt
        out.update(_prefixed(tag, _np(fe.extract(p, batch, imgs, t=500))))
        if tag == 'mesh':
            out['held'] = _held(fe.unet)
    return out


def case_dp2_sp2_pixart(rank, root):
    return _dit_case(rank, 'test-pixart',
                     {'vit-block0-out': True, 'vit-block1-self-map': True,
                      'vit-block0-ffn-inner': True, 'vit-block1-cross-q': True,
                      'vit-block0-self-k': True}, dict(dp=2, sp=2), 4, True)


def case_dp2_sp2_hunyuan(rank, root):
    return _dit_case(rank, 'test-hunyuan',
                     {'vit-block0-ffn-inner': True, 'vit-block1-self-q': True,
                      'vit-block2-cross-map': True, 'vit-block3-self-k': True},
                     dict(dp=2, sp=2), 4, True)


def case_dp2_tp2_pixart(rank, root):
    return _dit_case(rank, 'test-pixart',
                     {'vit-block0-out': True, 'vit-block1-self-map': True,
                      'vit-block0-ffn-inner': True, 'vit-block1-cross-q': True,
                      'vit-block0-self-k': True}, dict(dp=2, tp=2), 4, True)


def case_dp2_tp2_hunyuan(rank, root):
    return _dit_case(rank, 'test-hunyuan',
                     {'vit-block0-ffn-inner': True, 'vit-block1-self-q': True,
                      'vit-block2-cross-map': True, 'vit-block3-self-v': True},
                     dict(dp=2, tp=2), 4, True)


def case_dp2_tp2_if(rank, root):
    """IF's added-KV attention and text-time projection cut over tp (its
    attention has no taps: the resnets' and the output's)."""
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    layers = {'up-level1-repeat0-res-out': True, 'unet-out': True}
    imgs = [make_image(i) for i in range(4)]
    out = {}
    for tag, mesh in (('mesh', make_mesh(dp=2, tp=2)), ('plain', None)):
        if tag == 'plain' and rank != 0:
            break
        from diffusion_feature_tpu_torch import FeatureExtractor
        fe = FeatureExtractor(layers, 'test-if', device='cpu', dtype='float32', img_size=32,
                              mesh=mesh, seed=0)
        fe.feature_dtype = None
        out.update(_prefixed(tag, _np(fe.extract(fe.encode_prompt('a cat'), 4, imgs, t=500))))
        if tag == 'mesh':
            out['held'] = _held(fe.unet)
    return out


def case_sp2_tp2_flux(rank, root):
    return _dit_case(rank, 'test-flux',
                     {'vit-block0-out': True, 'vit-block0-q': True, 'vit-block0-ffn-inner': True,
                      'vit-block1-self-map': True, 'vit-block1-attn-out': True,
                      'vit-block2-q': True, 'vit-block2-k': True, 'vit-block2-attn-out': True,
                      'vit-block3-out': True, 'vit-block3-cross-map': True},
                     dict(sp=2, tp=2), 2, True)


def case_int8_tp(rank, root):
    """The auto int8 rule on each mesh shape, an explicit int8 Flux under
    dp2 x tp2 against the unsharded int8 Flux, and a deployment bundle
    written under dp=4 and loaded under dp2 x tp2 against the tree."""
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    tree = str(Path(root) / 'flux_tree')
    wait_for(Path(root) / 'flux_tree' / 'ready', 300)
    layers = {'vit-block0-out': True, 'vit-block2-out': True, 'vit-block0-q': True}
    auto = [_fe('test-flux', layers, make_mesh(**kw), weights=tree)
            for kw in (dict(dp=2, tp=2), dict(dp=4), dict(dp=2, sp=2))]
    rule = [x._int8_denoiser for x in auto]
    imgs = [make_image(i, SIZE) for i in range(4)]
    fe = _fe('test-flux', layers, make_mesh(dp=2, tp=2), weights=tree, transformer_8bit=True)
    out = {'rule': np.array(rule), 'tp_rank': np.array(fe.mesh.coords['tp'])}
    out.update(_prefixed('mesh', _np(fe.extract('a dog', 4, imgs, t=500))))
    for name in ('transformer_blocks.0.attn.to_q', 'transformer_blocks.0.attn.to_out.0',
                 'single_transformer_blocks.0.proj_out'):
        layer = fe.unet.get_submodule(name)
        out[f'mesh_q/{name}'] = layer.weight_q.numpy()
        out[f'mesh_scale/{name}'] = layer.scale.numpy()
    if rank == 0:
        plain = _fe('test-flux', layers, weights=tree, transformer_8bit=True)
        out.update(_prefixed('plain', _np(plain.extract('a dog', 4, imgs, t=500))))
        for name in ('transformer_blocks.0.attn.to_q', 'transformer_blocks.0.attn.to_out.0',
                     'single_transformer_blocks.0.proj_out'):
            layer = plain.unet.get_submodule(name)
            out[f'plain_q/{name}'] = layer.weight_q.numpy()
            out[f'plain_scale/{name}'] = layer.scale.numpy()
    # the dp=4 extractor's bundle (the first rank writes it, the others wait)
    # at the dp2 x tp2 mesh: its int8 flags from the manifest, each rank's
    # part equal to its part of the tree's load (a row-parallel layer's
    # stored scale is the whole row's); the tp extractor refuses to write one
    bundle = auto[1].save_converted(str(Path(root) / 'flux_bundle'))
    out['bundle_written'] = np.array(os.path.isfile(Path(bundle) / 'tpu_bundle.json'))
    from_bundle = _fe('test-flux', layers, make_mesh(dp=2, tp=2), weights=bundle)
    pairs = [(a.state_dict(), b.state_dict()) for a, b in zip(
        (fe.unet, fe.vae, *fe.text_encoders),
        (from_bundle.unet, from_bundle.vae, *from_bundle.text_encoders))]
    out['bundle_equal'] = np.array([a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a) for a, b in pairs])
    out['bundle_int8'] = np.array([from_bundle._int8_denoiser, from_bundle.spec.t5.quantize_int8])
    try:
        fe.save_converted(str(Path(root) / f'tp_bundle_{rank}'))
        out['tp_save_refused'] = np.array(False)
    except ValueError as e:
        out['tp_save_refused'] = np.array('under tp' in str(e))
    return out


def case_sample_dp4_xl(rank, root):
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    layer = {'up-level1-repeat0-res-out': True}
    out = {}
    for tag, mesh in (('mesh', make_mesh(dp=4)), ('plain', None)):
        if tag == 'plain' and rank != 0:
            break
        fe = _fe('test-xl', layer, mesh)
        images, feats = fe.sample(fe.encode_prompt('a cat'), batch_size=4,
                                  num_inference_steps=3, guidance_scale=5.0)
        out[f'{tag}/images'] = images.numpy()
        for i, x in enumerate(feats['up-level1-repeat0-res-out']):
            out[f'{tag}/call{i}'] = x.numpy()
    return out


def case_sample_indivisible(rank, root):
    """A batch that dp=4 does not divide runs whole on every rank, in
    sample() and in extract()."""
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    layer = {'up-level1-repeat0-res-out': True}
    imgs = [make_image(i) for i in range(3)]
    out = {}
    for tag, mesh in (('mesh', make_mesh(dp=4)), ('plain', None)):
        if tag == 'plain' and rank != 0:
            break
        fe = _fe('test-sd', layer, mesh)
        prompts = fe.encode_prompt('a cat')
        images, _ = fe.sample(prompts, batch_size=1, num_inference_steps=2, guidance_scale=5.0)
        out[f'{tag}/images'] = images.numpy()
        out.update(_prefixed(tag, _np(fe.extract(prompts, 3, imgs, t=50))))
    return out


def case_params_placed_once(rank, root):
    """Parameters are placed (and cut) once: two extracts move none."""
    from diffusion_feature_tpu_torch.parallel.mesh import make_mesh
    fe = _fe('test-sd', {'up-level1-repeat0-res-out': True}, make_mesh(dp=2, tp=2))
    prompts = fe.encode_prompt('a cat')
    imgs = [make_image(i) for i in range(4)]
    before = {k: (v.data_ptr(), tuple(v.shape)) for k, v in fe.unet.state_dict().items()}
    fe.extract(prompts, 4, imgs, t=50)
    fe.extract(prompts, 4, imgs, t=50)
    after = {k: (v.data_ptr(), tuple(v.shape)) for k, v in fe.unet.state_dict().items()}
    to_q = fe.unet.get_submodule('up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q')
    return {'same': np.array(before == after), 'to_q_rows': np.array(to_q.weight.shape[0])}


def case_uneven_heads(rank, root):
    """tp=4 over 10 heads (3, 3, 2, 2, SDXL's split) and GEGLU and GELU
    FFNs of an inner width tp does not divide: every tap, the store and
    the output against the unsharded modules."""
    from diffusion_feature_tpu_torch.models.layers import (AttnStoreCfg, BasicTransformerBlock,
                                                           FeedForward)
    from diffusion_feature_tpu_torch.parallel.mesh import cut_parameters_, make_mesh, parallelize
    from diffusion_feature_tpu_torch.taps import TapSpec
    mesh = make_mesh(tp=4)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 36, 80, generator=gen)
    ctx = torch.randn(2, 5, 16, generator=gen)
    taps = TapSpec(ids=frozenset({'b-self-q', 'b-self-k', 'b-self-map', 'b-cross-map',
                                  'b-ffn-inner', 'b-out', 'f-inner', 'g-inner'}))
    store = AttnStoreCfg('up', 1, 100, frozenset({'up_self', 'up_cross'}))

    def modules():
        torch.manual_seed(5)
        return (BasicTransformerBlock(80, 10, 8, 16, taps, 'b', store),
                FeedForward(80, taps, 'f', 'geglu', inner=322),
                FeedForward(80, taps, 'g', 'gelu-approximate', inner=322))

    out = {}
    for tag in ('plain', 'mesh'):
        block, ffg, ffl = modules()
        if tag == 'mesh':
            for m in (block, ffg, ffl):
                cut_parameters_(m, parallelize(m, mesh))
        feats = {}
        with torch.no_grad():
            y = block(x, ctx, feats)
            z = ffg(x, feats) + ffl(x, feats)
        store_maps = feats.pop('attn_store')
        out.update(_prefixed(tag, {**{k: v.numpy() for k, v in feats.items()},
                                   'y': y.numpy(), 'z': z.numpy(),
                                   **{f'{k}{i}': m.numpy() for k, ms in store_maps.items()
                                      for i, m in enumerate(ms)}}))
    out['heads'] = np.array(block.attn1.heads)
    # the other collective the port keeps: rank 0's tensor on every rank
    out['broadcast'] = mesh.axis('tp').broadcast(torch.full((3,), float(rank))).numpy()
    return out


def _write_images(d, n):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        make_image(i, SIZE).save(d / f'img{i}.png')


def case_cli_dp2(rank, root):
    """The CLI with --batch_size 3 --dp 2 (rounded up to 4) on each pair
    of ranks, and --dp 1 at batch 4 on rank 0: 5 images, so the trailing
    batch of 1 leaves one rank of each pair without rows."""
    from diffusion_feature_tpu_torch import extract_feature
    root = Path(root)
    pair, group = _pair_group(rank)
    common = ['--version', 'test-sd', '--img_size', str(SIZE), '--dtype', 'float32',
              '--device', 'cpu', '--prompt', 'a photo of a cat', '--layer',
              json.dumps({'up-level1-repeat0-res-out': True, 'mid-vit-block0-self-q': True}),
              '--input_dir', str(root / 'cli_imgs' / '*.png')]
    extract_feature.main(common + ['--dp', '2', '--batch_size', '3', '--output_dir',
                                   str(root / f'cli_dp2_pair{pair[0]}')], group=group)
    if rank == 0:
        extract_feature.main(common + ['--batch_size', '4', '--output_dir',
                                       str(root / 'cli_dp1')])
    return {}


def seg_config(root):
    layers = {'up-level0-repeat1-res-out': True, 'up-level1-repeat0-vit-block0-cross-q': True}
    return {'diffusion_feature': {'layer': layers, 'version': 'test-sd', 'attention': None,
                                  'img_size': SIZE, 't': [50, 100]},
            'feature_layers': [[['up-level0-repeat1-res-out', 64]],
                               [['up-level1-repeat0-vit-block0-cross-q', 32]]],
            'num_classes': SEG_CLASSES, 'head_channels': 8, 'pool_scales': [1, 2],
            'prompt': 'a photo', 'crop_size': [32, 32], 'stride': [24, 24]}


def _write_pairs(root, n, size=(40, 48)):
    rs = np.random.RandomState(11)
    (root / 'seg_imgs').mkdir(parents=True, exist_ok=True)
    (root / 'seg_labels').mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, size + (3,), np.uint8)).save(root / f'seg_imgs/p{i}.png')
        Image.fromarray(rs.randint(0, SEG_CLASSES, size).astype(np.uint8)).save(
            root / f'seg_labels/p{i}.png')


def case_trainer_dp2(rank, root):
    """Two trainer steps with --dp 2 on each pair of ranks, and --dp 1 on
    rank 0, from the same seed: losses, the head's parameters and its
    BatchNorm statistics afterwards."""
    from diffusion_feature_tpu_torch import train_segmentation as trainer
    root = Path(root)
    pair, group = _pair_group(rank)
    base = ['--config', str(root / 'seg.json'), '--train_img_dir', str(root / 'seg_imgs'),
            '--train_label_dir', str(root / 'seg_labels'), '--max_iters', '2',
            '--batch_size', '2', '--device', 'cpu', '--reduce_zero_label', '--val_every', '100']
    out = {}
    runs = [('dp2', ['--dp', '2', '--work_dir', str(root / f'seg_dp2_{pair[0]}')], group)]
    if rank == 0:
        runs.append(('dp1', ['--work_dir', str(root / 'seg_dp1')], None))
    step = trainer.train_step
    for tag, flags, g in runs:
        grads = []

        def recording_step(seg, opt, *args, **kw):
            result = step(seg, opt, *args, **kw)   # the gradients stay on the parameters
            if not grads:
                grads.append({k: p.grad.clone() for k, p in seg.head.named_parameters()})
            return result
        trainer.train_step = recording_step
        try:
            run = trainer.main(base + flags, group=g)
        finally:
            trainer.train_step = step
        out[f'{tag}/losses'] = np.array(run['losses'])
        for k, v in run['seg'].state_dict().items():
            out[f'{tag}/{k}'] = v.float().numpy()
        for k, v in grads[0].items():
            out[f'{tag}/grad/head.{k}'] = v.numpy()
    return out


CASES = {name[len('case_'):]: fn for name, fn in globals().items() if name.startswith('case_')}
#: The order the ranks run them in: the JAX-input cases last, so the
#: parent has time to write their inputs.
ORDER = ('uneven_heads', 'dp4_sd', 'params_placed_once', 'dp2_sp2_pixart', 'dp2_sp2_hunyuan',
         'dp2_tp2_pixart', 'dp2_tp2_hunyuan', 'dp2_tp2_if', 'sp2_tp2_flux', 'sample_dp4_xl', 'sample_indivisible', 'cli_dp2', 'trainer_dp2',
         'int8_tp', 'dp2_tp2_sd', 'dp2_sp2_flux')


def run(rank: int, world: int, port: int, root: str):
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        if rank == 0:
            _write_images(root / 'cli_imgs', 5)
            _write_pairs(root, 3)
            (root / 'seg.json').write_text(json.dumps(seg_config(root)))
        dist.barrier()
        for name in ORDER:
            try:
                result = CASES[name](rank, str(root))
                np.savez(root / f'{name}.r{rank}.npz', **(result or {}))
            except Exception:
                (root / f'{name}.r{rank}.err').write_text(traceback.format_exc())
            (root / f'{name}.r{rank}.done').touch()
            dist.barrier()
    finally:
        dist.destroy_process_group()
