"""Semantic-correspondence helpers: cosine-similarity nearest neighbour and
PCK@k (port of ``diffusion_feature_tpu/tasks/correspondence/utils.py``,
the reference's correspondence/correspondence/correspondence_utils.py).

Conventions preserved exactly: points are (y, x); image sizes are (w, h);
``points_to_idxs`` flattens with ``load_size[1] * round(y) + round(x)``
(:144-150); PCK thresholds by max image side or bbox side (:160-167).
Point and size arithmetic stays in numpy; features are tensors on their
device.  ``torch.argmax`` returns the first maximum, as JAX's does.

The best-buddies and cyclical matchers diversify their picks with
``kmeans``, written here (k-means++ seeds from ``np.random.RandomState(0)``,
10 restarts, Lloyd iterations to convergence, the lowest inertia kept), where the JAX package calls scikit-learn's ``KMeans``.  The two find
the same partition of well-separated clusters, but not bit for bit the same
centres elsewhere, and number the clusters differently: the matchers return
one pick per cluster in cluster order, so their rows come in another order.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch

from ...ops.resize import resize_bilinear_nchw


def rescale_points(points: np.ndarray, old_shape, new_shape) -> np.ndarray:
    """(y, x) points; shapes are (w, h) (reference :23-29)."""
    x_scale = new_shape[0] / old_shape[0]
    y_scale = new_shape[1] / old_shape[1]
    return np.multiply(points, np.array([y_scale, x_scale]))


def points_to_idxs(points: np.ndarray, load_size) -> np.ndarray:
    points_y = np.clip(points[:, 0], 0, load_size[1] - 1)
    points_x = np.clip(points[:, 1], 0, load_size[0] - 1)
    return load_size[1] * np.round(points_y) + np.round(points_x)


def flatten_feats(feats: torch.Tensor) -> torch.Tensor:
    """(b, c, w, h) -> (b, w*h, c)."""
    b, c, w, h = feats.shape
    return feats.reshape(b, c, w * h).transpose(1, 2)


def normalize_feats(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def batch_cosine_sim(img1_feats: torch.Tensor, img2_feats: torch.Tensor,
                     flatten: bool = True, normalize: bool = True) -> torch.Tensor:
    if flatten:
        img1_feats = flatten_feats(img1_feats)
        img2_feats = flatten_feats(img2_feats)
    if normalize:
        img1_feats = normalize_feats(img1_feats)
        img2_feats = normalize_feats(img2_feats)
    return torch.matmul(img1_feats, img2_feats.transpose(1, 2))


def find_nn_source_correspondences(img1_feats: torch.Tensor, img2_feats: torch.Tensor,
                                   source_points, output_size, load_size):
    """Nearest-neighbour matches of the annotated source points
    (reference :117-141): features bilinearly upsampled to ``load_size``
    (``resize_bilinear_nchw``, jax.image.resize's bilinear, which upsamples
    as ``F.interpolate(align_corners=False)`` does), the source rows
    gathered, argmax over target positions.  Returns (source points as an
    fp32 tensor, as JAX's ``jnp.asarray`` makes them, (n, 2) predicted (y,
    x) on the features' device)."""
    img1_feats = resize_bilinear_nchw(img1_feats, tuple(load_size))
    img2_feats = resize_bilinear_nchw(img2_feats, tuple(load_size))
    source_idx = torch.as_tensor(points_to_idxs(np.asarray(source_points), load_size),
                                 dtype=torch.long, device=img1_feats.device)
    f1 = flatten_feats(img1_feats)[:, source_idx, :]
    f2 = flatten_feats(img2_feats)
    sims = torch.matmul(normalize_feats(f1), normalize_feats(f2).transpose(1, 2))

    num_pixels = int(math.sqrt(sims.shape[-1]))
    points2 = sims.argmax(dim=-1)
    points2 = torch.stack([points2 // num_pixels, points2 % num_pixels], dim=-1)
    return torch.as_tensor(np.asarray(source_points), dtype=torch.float32), points2[0]


def compute_pck(predicted_points: np.ndarray, target_points: np.ndarray,
                load_size, pck_threshold: float = 0.1,
                target_bounding_box=None) -> Tuple[np.ndarray, np.ndarray, float]:
    distances = np.linalg.norm(predicted_points - target_points, axis=-1)
    if target_bounding_box is None:
        pck = distances <= pck_threshold * max(load_size)
    else:
        left, top, right, bottom = target_bounding_box
        pck = distances <= pck_threshold * max(right - left, bottom - top)
    return distances, pck, pck.sum() / len(pck)


def draw_correspondences(source_points, predicted_points, img1, img2,
                         out_path: str, radius: int = 4, title: str = ''):
    """Side-by-side visualization of source points and their predicted
    matches (reference correspondence_utils.py:172-213; PIL instead of
    matplotlib).  Points are (y, x), numpy arrays or tensors."""
    from PIL import Image, ImageDraw

    img1 = img1.convert('RGB')
    img2 = img2.convert('RGB')
    h = max(img1.height, img2.height)
    canvas = Image.new('RGB', (img1.width + img2.width, h + 16), 'white')
    canvas.paste(img1, (0, 16))
    canvas.paste(img2, (img1.width, 16))
    draw = ImageDraw.Draw(canvas)
    if title:
        draw.text((4, 2), title, fill='black')
    n = len(source_points)
    for i, (sp, tp) in enumerate(zip(_numpy(source_points), _numpy(predicted_points))):
        hue = int(360 * i / max(n, 1))
        color = f'hsl({hue}, 90%, 45%)'
        y1, x1 = float(sp[0]) + 16, float(sp[1])
        y2, x2 = float(tp[0]) + 16, float(tp[1]) + img1.width
        draw.ellipse([x1 - radius, y1 - radius, x1 + radius, y1 + radius],
                     outline=color, width=2)
        draw.ellipse([x2 - radius, y2 - radius, x2 + radius, y2 + radius],
                     outline=color, width=2)
    canvas.save(out_path)
    return out_path


def load_annotation(ann: dict, load_size, image_path: str = ''):
    """SPair annotation -> (source_points, target_points, src_path, tgt_path,
    category), points flipped to (y, x) and rescaled to load_size
    (reference load_image_pair, :21-49).  Records source/target_size on the
    annotation in place, like the reference."""
    from PIL import Image
    src = Image.open(os.path.join(image_path, ann['source_path'])).convert('RGB')
    tgt = Image.open(os.path.join(image_path, ann['target_path'])).convert('RGB')
    ann['source_size'] = src.size
    ann['target_size'] = tgt.size
    source_points = np.flip(np.asarray(ann['source_points'], np.float64), 1)
    target_points = np.flip(np.asarray(ann['target_points'], np.float64), 1)
    source_points = rescale_points(source_points, src.size, load_size)
    target_points = rescale_points(target_points, tgt.size, load_size)
    return (source_points, target_points, ann['source_path'],
            ann['target_path'], ann['category'])


# --------------------------------------------------------------------------
# Dense / unsupervised correspondence extras (reference
# correspondence_utils.py:89-111 find_nn_correspondences, :146-158
# points_to_patches, :230-323 best-buddies, :338-467 cyclical).  The
# reference's task loop never calls these, but they are part of the public
# helper surface; semantics (column conventions, fg masking, k-means
# selection) are preserved.

def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def find_nn_correspondences(sims: torch.Tensor):
    """Dense NN matches over a (B, w*h, w*h) similarity matrix
    (reference :89-111).  Returns (points1 (B, w*h, 2), points2 (B, w*h, 2))
    in (y, x) order, fp32; points1 enumerates image1's grid."""
    w = h = int(math.sqrt(sims.shape[-1]))
    b = sims.shape[0]
    yy, xx = torch.meshgrid(torch.arange(w, device=sims.device),
                            torch.arange(h, device=sims.device), indexing='ij')
    points1 = torch.stack([yy, xx], dim=-1).reshape(-1, 2)
    points1 = points1[None].expand(b, w * h, 2)

    points2 = sims.argmax(dim=-1)
    points2 = torch.stack([points2 // h, points2 % h], dim=-1)
    return points1.float(), points2.float()


def points_to_patches(source_points: np.ndarray, num_patches: int,
                      load_size) -> np.ndarray:
    """Image-space (y, x) points -> patch-grid coordinates (reference
    :146-158; load_size is (w, h), rounding + boundary clip preserved)."""
    source_points = np.round(np.asarray(source_points, np.float64))
    source_patches_y = (num_patches / load_size[1]) * source_points[:, 0]
    source_patches_x = (num_patches / load_size[0]) * source_points[:, 1]
    patches = np.stack([source_patches_y, source_patches_x], axis=-1)
    return np.round(np.clip(patches, 0, num_patches - 1))


def chunk_cosine_sim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between descriptor sets (B, 1, T, D) -> (B, 1, Tx, Ty)
    (reference chunk_cosine_sim semantics, one chunk per head dim).  Norms
    clamp at torch.nn.CosineSimilarity's eps=1e-8 so an all-zero descriptor
    yields 0 similarity, not NaN."""
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp(min=1e-8)
    return torch.einsum('bhtd,bhsd->bhts', xn, yn)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.RandomState) -> np.ndarray:
    """k-means++ seeding: the first centre uniform, each next one drawn with
    probability proportional to the squared distance to the nearest centre
    so far."""
    centres = [x[rng.randint(len(x))]]
    d2 = ((x - centres[0]) ** 2).sum(axis=1)
    for _ in range(1, k):
        total = d2.sum()
        i = rng.randint(len(x)) if total <= 0 else rng.choice(len(x), p=d2 / total)
        centres.append(x[i])
        d2 = np.minimum(d2, ((x - x[i]) ** 2).sum(axis=1))
    return np.stack(centres)


# scikit-learn's KMeans defaults, which the JAX package's matchers use
_KMEANS_SEED, _N_INIT, _MAX_ITER, _TOL = 0, 10, 300, 1e-4


def kmeans(x: np.ndarray, n_clusters: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """k-means of the rows of ``x`` -> (labels (N,), centres (k, D),
    inertia): ``_N_INIT`` k-means++ seedings from
    ``RandomState(_KMEANS_SEED)``, each followed by Lloyd iterations (at most
    ``_MAX_ITER``) until no label changes or the centres move by less than
    ``_TOL`` times the data's mean variance (squared), the run of the lowest
    inertia kept.  An emptied cluster takes the point farthest from its
    centre."""
    x = np.asarray(x, np.float64)
    rng = np.random.RandomState(_KMEANS_SEED)
    threshold = _TOL * x.var(axis=0).mean()
    best = None
    for _ in range(_N_INIT):
        centres = _kmeans_pp(x, n_clusters, rng)
        labels = None
        for _ in range(_MAX_ITER):
            d2 = ((x[:, None, :] - centres[None]) ** 2).sum(axis=-1)
            new = d2.argmin(axis=1)
            moved = centres.copy()
            for c in range(n_clusters):
                members = new == c
                if members.any():
                    moved[c] = x[members].mean(axis=0)
                else:
                    far = d2[np.arange(len(x)), new].argmax()
                    moved[c], new[far] = x[far], c
            shift = ((moved - centres) ** 2).sum()
            done = labels is not None and np.array_equal(new, labels)
            centres, labels = moved, new
            if done or shift <= threshold:
                break
        d2 = ((x[:, None, :] - centres[None]) ** 2).sum(axis=-1)
        labels = d2.argmin(axis=1)
        inertia = float(d2[np.arange(len(x)), labels].sum())
        if best is None or inertia < best[2]:
            best = (labels, centres, inertia)
    return best


def _kmeans_select(descriptors: np.ndarray, ranks: np.ndarray,
                   n_clusters: int) -> np.ndarray:
    """k-means over normalized descriptors; per cluster keep the
    highest-ranked member (the reference's selection loop, :305-311)."""
    labels, _, _ = kmeans(descriptors, n_clusters)
    chosen = np.full(n_clusters, -1, np.int64)
    best = np.full(n_clusters, -np.inf)
    for i, (label, rank) in enumerate(zip(labels, ranks)):
        if rank > best[label]:
            best[label] = rank
            chosen[label] = i
    return chosen[chosen >= 0]


def find_best_buddies_correspondences(descriptors1, descriptors2,
                                      saliency_map1, saliency_map2,
                                      num_pairs: int = 10,
                                      thresh: float = 0.05):
    """Mutual-nearest-neighbour ("best buddies") matching with saliency
    fg-masking and k-means diversification (reference :230-323).
    descriptors (B, 1, T, D); saliency (B, T); arrays or tensors.  Returns
    (points1, points2) in patch-grid (y, x) coordinates, numpy fp64."""
    d1 = _numpy(descriptors1).astype(np.float32)
    d2 = _numpy(descriptors2).astype(np.float32)
    t = d1.shape[2]
    n = int(np.sqrt(t))
    sal1 = _numpy(saliency_map1).astype(np.float32)[0]
    sal2 = _numpy(saliency_map2).astype(np.float32)[0]
    fg1, fg2 = sal1 > thresh, sal2 > thresh

    sims = chunk_cosine_sim(torch.from_numpy(d1), torch.from_numpy(d2)).numpy()[0, 0]
    nn_1 = sims.argmax(axis=-1)          # img1 -> img2
    nn_2 = sims.argmax(axis=-2)          # img2 -> img1
    idxs = np.arange(t)
    bbs_mask = nn_2[nn_1] == idxs

    fg2_new = np.zeros(t, bool)
    fg2_new[nn_2[fg2]] = True
    bbs_mask = bbs_mask & fg1 & fg2_new
    if not bbs_mask.any():
        return np.zeros((0, 2)), np.zeros((0, 2))

    bb_d1 = d1[0, 0, bbs_mask]
    bb_d2 = d2[0, 0, nn_1[bbs_mask]]
    all_desc = np.concatenate([bb_d1, bb_d2], axis=1)
    all_desc = all_desc / np.sqrt((all_desc ** 2).sum(axis=1))[:, None]
    n_clusters = min(num_pairs, len(all_desc))
    ranks = (sal1[bbs_mask] + sal2[nn_1[bbs_mask]]) / 2
    sel = _kmeans_select(all_desc, ranks, n_clusters)

    src = np.nonzero(bbs_mask)[0][sel]
    tgt = nn_1[src]
    points1 = np.stack([src // n, src % n], axis=-1).astype(np.float64)
    points2 = np.stack([tgt // n, tgt % n], axis=-1).astype(np.float64)
    return points1, points2


def find_cyclical_correspondences(descriptors1, descriptors2,
                                  saliency_map1, saliency_map2,
                                  num_pairs: int = 10,
                                  thresh: float = 0.05):
    """Cycle-consistency matching: image1 -> image2 -> image1, keep the
    points with the smallest cycle distance, fg-masked, k-means-diversified
    (reference :338-467).  Returns (points1, points2) patch-grid (y, x),
    numpy fp64."""
    d1 = _numpy(descriptors1).astype(np.float32)
    d2 = _numpy(descriptors2).astype(np.float32)
    t = d1.shape[2]
    n = int(np.sqrt(t))
    sal1 = _numpy(saliency_map1).astype(np.float32)
    sal2 = _numpy(saliency_map2).astype(np.float32)
    fg1, fg2 = sal1 > thresh, sal2 > thresh

    sims = chunk_cosine_sim(torch.from_numpy(d1), torch.from_numpy(d2)).numpy()
    nn_1 = sims.argmax(axis=-1)[:, 0]    # (B, T)
    nn_2 = sims.argmax(axis=-2)[:, 0]

    # bg points in image2 map to 0 (reference's top-left sentinel, :391)
    nn_2 = np.where(fg2, nn_2, 0)
    cyc = np.take_along_axis(nn_2, nn_1, axis=-1)     # nn_2[nn_1]

    cyc_ij = np.stack([cyc // n, cyc % n], axis=-1).astype(np.float64)
    img_ij = np.stack([np.arange(t) // n, np.arange(t) % n], axis=-1)
    img_ij = np.broadcast_to(img_ij, cyc_ij.shape).astype(np.float64)
    cyc_ij = np.where(cyc_ij == 0, float(t), cyc_ij)  # sentinel -> far away

    dists = -np.linalg.norm(cyc_ij - img_ij, axis=-1)            # (B, T)
    dn = dists - dists.min(axis=1, keepdims=True)
    dn = dn / np.maximum(dn.max(axis=1, keepdims=True), 1e-12)
    dn = dn * fg1.astype(np.float64)

    topk = np.argsort(-dn, axis=-1)[:, :num_pairs * 2]
    sel1 = []
    for bi in range(d1.shape[0]):
        idxs_b = topk[bi]
        feats = d1[bi, 0][idxs_b]
        feats = feats / np.maximum(
            np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)
        k = min(num_pairs, len(feats))
        labels, _, _ = kmeans(feats, k)
        chosen = []
        for kk in range(k):
            members = np.where(labels == kk)[0]
            if not len(members):
                continue
            best = members[sal1[bi][idxs_b[members]].argmax()]
            chosen.append(idxs_b[best])
        sel1.append(np.asarray(chosen))
    sel1 = np.stack(sel1)
    sel2 = np.take_along_axis(nn_1, sel1, axis=-1)

    points1 = np.stack([sel1[0] // n, sel1[0] % n], axis=-1).astype(np.float64)
    points2 = np.stack([sel2[0] // n, sel2[0] % n], axis=-1).astype(np.float64)
    return points1, points2
