"""Deterministic category color map.

The port's copy of proxytransformation_tpu/visualization/color_selector.py
(pure Python: an md5 of the name → HSV → RGB in [0, 1])."""
from __future__ import annotations

import colorsys
import hashlib
from typing import Sequence, Tuple


class ColorMap:

    def __init__(self, classes: Sequence[str] = ()):
        self.classes = list(classes)

    @staticmethod
    def _hash_color(name: str) -> Tuple[float, float, float]:
        h = int(hashlib.md5(name.encode()).hexdigest()[:8], 16)
        hue = (h % 360) / 360.0
        sat = 0.55 + ((h >> 9) % 40) / 100.0
        val = 0.75 + ((h >> 17) % 25) / 100.0
        return colorsys.hsv_to_rgb(hue, sat, min(val, 1.0))

    def get_color(self, category: str) -> Tuple[float, float, float]:
        return self._hash_color(category)

    def __getitem__(self, category_or_label):
        if isinstance(category_or_label, int):
            if 0 <= category_or_label < len(self.classes):
                return self._hash_color(self.classes[category_or_label])
            return self._hash_color(str(category_or_label))
        return self._hash_color(category_or_label)
