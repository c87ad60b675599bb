"""SPair-71k semantic correspondence (port of
``diffusion_feature_tpu/tasks/correspondence``): the aggregation network
over frozen extractors, nearest-neighbour, best-buddies and cyclical
matchers, PCK; the CLI is ``diffusion_feature_tpu_torch.task_corres``."""

from .utils import (
    rescale_points, points_to_idxs, compute_pck, batch_cosine_sim,
    draw_correspondences, find_nn_source_correspondences, load_annotation,
    find_nn_correspondences, points_to_patches, chunk_cosine_sim,
    find_best_buddies_correspondences, find_cyclical_correspondences,
)
from .aggregation import AggregationNetwork, SPAIR_PROMPT
