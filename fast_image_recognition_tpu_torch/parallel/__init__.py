from fast_image_recognition_tpu_torch.parallel.mesh import Mesh, gallery_mesh, make_mesh  # noqa: F401
from fast_image_recognition_tpu_torch.parallel.sharded_gallery import (  # noqa: F401
    ShardedGalleryMatcher,
    shard_gallery,
    shard_gallery_pca_aug,
    sharded_topk_l2,
    sharded_topk_pca_packed,
)
