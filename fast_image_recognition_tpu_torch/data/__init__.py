from .feature_io import FeatureDB, load_feature_file, normalize_features, write_feature_file  # noqa: F401
from .splits import Split, split_by_class_fraction, train_test_split_images  # noqa: F401
from .synthetic import make_gallery_and_probes, make_synthetic_gallery  # noqa: F401
