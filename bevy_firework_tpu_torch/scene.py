"""Scene-level types. This slice holds only `Transform`; the Scene facade
(groups, events, render items) is still to be ported (ROADMAP queue 1
item 7)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Transform:
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)  # xyzw
