from .harness import (EvalResult, evaluate_classifier, evaluate_matcher, get_threshold,  # noqa: F401
    repeated_splits_eval)
