from fast_image_recognition_tpu_torch.data.feature_io import (  # noqa: F401
    FeatureDB,
    load_feature_file,
    normalize_features,
    write_feature_file,
)
from fast_image_recognition_tpu_torch.data.splits import (  # noqa: F401
    Split,
    split_by_class_fraction,
    train_test_split_images,
)
from fast_image_recognition_tpu_torch.data.synthetic import (  # noqa: F401
    make_gallery_and_probes,
    make_synthetic_gallery,
)
