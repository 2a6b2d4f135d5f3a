from fast_image_recognition_tpu_torch.ops.distances import (  # noqa: F401
    oracle_distance,
    oracle_pairwise,
    pairwise_distances,
)
