"""Early-exit cascades: exit policies (``exits``), the segment engine
(``engine``) and three-way-decision classifiers (``twd``)."""

from .twd import ConventionalTWD, ProposedTWD, TWDType  # noqa: F401
