"""The input-format string DSL.

The port's copy of ``read_tpu/scene/formats.py`` (``RenderSpec``,
``parse_input_string``, ``parse_input_format``): token grammar
``<mode>[_p<size>|_ps<size>][_ds<level>]`` with modes ``colors | uv_1d |
uv_2d | normals_{m,r,l,d} | xyz | depth | labels``. ``p`` draws
fixed-size points, ``ps`` splats (z-scaled point size), ``ds`` selects
the pyramid downscale level.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["RenderSpec", "parse_input_string", "parse_input_format"]


@dataclass(frozen=True)
class RenderSpec:
    """One rendered modality of the input pyramid."""
    mode: str
    draw_points: bool = False
    point_size: int = 1
    splat_mode: bool = False      # 'ps' = z-relative point size
    flat_color: bool = False
    downscale: Optional[int] = None  # ds level; None = from list position

    @property
    def channels(self) -> int:
        """Channel count of this modality's rendered map."""
        return 1 if self.mode in ("depth", "labels", "uv_1d") else 3


def parse_input_string(string: str) -> RenderSpec:
    """Parse one token."""
    if re.search(r"^colors", string):
        mode = "colors"
    elif re.search(r"^uv", string):
        found = re.findall(r"uv_1d|uv_2d", string)
        if not found:
            raise ValueError(string)
        mode = found[-1]
    elif re.search(r"^normals", string):
        found = re.findall(r"normals_[mrld]", string)
        if not found:
            raise ValueError(string)
        mode = found[-1]
    elif re.search(r"^xyz", string):
        mode = "xyz"
    elif re.search(r"^depth", string):
        mode = "depth"
    elif re.search(r"^labels", string):
        mode = "labels"
    else:
        raise ValueError(string)

    res = re.findall(r"ps[0-9]+|p[0-9]+", string)
    if res:
        tok = res[-1]
        draw_points = flat_color = True
        point_size = int(re.search(r"[0-9]+", tok).group())
        splat_mode = tok.startswith("ps")
    else:
        draw_points, flat_color = False, False
        point_size, splat_mode = 1, False

    ds = re.findall(r"ds[0-5]+", string)
    downscale = int(re.search(r"[0-9]+", ds[-1]).group()) if ds else None
    return RenderSpec(mode=mode, draw_points=draw_points,
                      point_size=point_size, splat_mode=splat_mode,
                      flat_color=flat_color, downscale=downscale)


def parse_input_format(fmt: str) -> List[RenderSpec]:
    """Split a comma-separated input format into specs; each entry's
    effective scale is its list position unless an explicit ``ds`` token
    overrides it."""
    return [parse_input_string(tok)
            for tok in fmt.replace(" ", "").split(",") if tok]
