from fast_image_recognition_tpu_torch.classifiers.knn import KNNClassifier  # noqa: F401
from fast_image_recognition_tpu_torch.classifiers.parzen import (  # noqa: F401
    PNNClassifier,
    PNNWithClusteringClassifier,
)
from fast_image_recognition_tpu_torch.classifiers.fpnn import FPNNClassifier  # noqa: F401
