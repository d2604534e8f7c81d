"""Color-name -> (hue, saturation) lookup (a copy of
`t2onet_tpu.ops.color_names`).

A built-in CSS-style map is the default; a user JSON (name -> [h, s, v])
can replace it. Hue is in [0, 1), the package's HSV convention.
"""

from __future__ import annotations

import colorsys
import json
from typing import Dict, List, Optional, Tuple

# (r, g, b) in 0..255 for a practical palette of editing-request colors
_RGB = {
    "red": (255, 0, 0), "dark red": (139, 0, 0), "crimson": (220, 20, 60),
    "orange": (255, 165, 0), "dark orange": (255, 140, 0),
    "gold": (255, 215, 0), "yellow": (255, 255, 0),
    "green": (0, 128, 0), "dark green": (0, 100, 0),
    "light green": (144, 238, 144), "olive": (128, 128, 0),
    "teal": (0, 128, 128), "cyan": (0, 255, 255),
    "blue": (0, 0, 255), "dark blue": (0, 0, 139),
    "light blue": (173, 216, 230), "navy": (0, 0, 128),
    "purple": (128, 0, 128), "violet": (238, 130, 238),
    "magenta": (255, 0, 255), "pink": (255, 192, 203),
    "brown": (165, 42, 42), "dark brown": (101, 67, 33),
    "light brown": (181, 101, 29), "tan": (210, 180, 140),
    "beige": (245, 245, 220), "white": (255, 255, 255),
    "gray": (128, 128, 128), "grey": (128, 128, 128),
    "black": (0, 0, 0), "sepia": (112, 66, 20),
}


def _hsv(rgb: Tuple[int, int, int]) -> List[float]:
    h, s, v = colorsys.rgb_to_hsv(*(c / 255.0 for c in rgb))
    return [h, s, v]


NAME_HSV_MAP: Dict[str, List[float]] = {k: _hsv(v) for k, v in _RGB.items()}


def get_color_from_name(name: str, map_path: Optional[str] = None
                        ) -> Tuple[List[List[float]], List[str]]:
    """All colors whose key contains `name` -> ([(h, s), ...], [names...]).

    A substring match over the keys; returns the (h, s) pairs.
    """
    table = NAME_HSV_MAP
    if map_path is not None:
        with open(map_path) as f:
            table = json.load(f)
    matches = [k for k in table if name in k]
    return [list(table[k][:2]) for k in matches], matches
