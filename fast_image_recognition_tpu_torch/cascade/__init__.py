"""Early-exit cascades: exit policies (``exits``), the segment engine
(``engine``) and three-way-decision classifiers (``twd``)."""

from fast_image_recognition_tpu_torch.cascade.twd import (  # noqa: F401
    ConventionalTWD,
    ProposedTWD,
    TWDType,
)
