from .brute_force import BruteForceMatcher  # noqa: F401
from .base import Matcher, SearchResult  # noqa: F401
