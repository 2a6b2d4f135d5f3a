from .mesh import Mesh, gallery_mesh, make_mesh  # noqa: F401
from .sharded_gallery import (ShardedGalleryMatcher, shard_gallery, shard_gallery_pca_aug,  # noqa: F401
    sharded_topk_l2, sharded_topk_pca_packed)
