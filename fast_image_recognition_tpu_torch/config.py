"""Runtime configuration of the port (the port's own copy of
``fast_image_recognition_tpu/config.py``; so far ``DistanceKind`` only)."""

from __future__ import annotations

import enum


class DistanceKind(str, enum.Enum):
    """Distance selected by USE_L2_DISTANCE / chi2 / KL in the reference
    (qt_cpp/db_features.cpp:22-42)."""

    L2 = "l2"
    CHI2 = "chi2"
    KL = "kl"
