from fast_image_recognition_tpu_torch.evaluation.harness import (  # noqa: F401
    EvalResult,
    evaluate_classifier,
    evaluate_matcher,
    get_threshold,
    repeated_splits_eval,
)
