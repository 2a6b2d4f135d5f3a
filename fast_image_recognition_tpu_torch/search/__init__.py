from fast_image_recognition_tpu_torch.search.brute_force import BruteForceMatcher  # noqa: F401
from fast_image_recognition_tpu_torch.search.base import Matcher, SearchResult  # noqa: F401
