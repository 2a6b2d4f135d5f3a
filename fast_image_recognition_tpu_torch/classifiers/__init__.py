from .knn import KNNClassifier  # noqa: F401
from .parzen import PNNClassifier, PNNWithClusteringClassifier  # noqa: F401
from .fpnn import FPNNClassifier  # noqa: F401
