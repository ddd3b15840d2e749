"""Point-cloud operators: gathers, KNN pyramid, matcher, pose solve, the
voxel grid, radius matches, ICP and RANSAC, Sinkhorn and PointNet++
grouping. The names below are those deepsir_tpu/ops/__init__.py exports."""
from deepsir_tpu_torch.ops.gather import (  # noqa: F401
    gather_neighbour, gather_points, max_pool_neighbours, nearest_interpolate,
)
from deepsir_tpu_torch.ops.distance import (  # noqa: F401
    square_distance, match_features, nearest_neighbour_index, pairwise_dist_chunked,
)
from deepsir_tpu_torch.ops.knn import knn  # noqa: F401
from deepsir_tpu_torch.ops.pyramid import build_pyramid, Pyramid  # noqa: F401
from deepsir_tpu_torch.ops.svd3 import weighted_kabsch, svd3x3  # noqa: F401
from deepsir_tpu_torch.ops.voxel import voxel_downsample_np, voxel_downsample  # noqa: F401
from deepsir_tpu_torch.ops.sinkhorn import sinkhorn, compute_affinity  # noqa: F401
