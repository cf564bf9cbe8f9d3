"""Texture table (counterpart of the JAX reference's ``textures.py``).

Only the constant-value path of ``evaluate`` is ported: a table of constant
colors, addressed by texture id, assembled by ``TextureBuilder``. Image
maps, procedural textures, texture graphs and 2D/3D mappings raise
``NotImplementedError`` at build time (ROADMAP Queue 1 item 6, textures).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .core import math as vm

CONST = 0


@dataclasses.dataclass
class TextureData:
    kind: Any      # (T,) int32
    value: Any     # (T, 3) constant value
    n: int = 0
    kinds_present: tuple = (CONST,)


class TextureBuilder:
    """The texture table, one row per ``add`` (the scene API adds one per
    ``Texture`` statement); rows are constant colors."""

    def __init__(self):
        self.values = []

    def add(self, value) -> int:
        self.values.append(np.asarray(value, np.float32))
        return len(self.values) - 1

    def build(self) -> TextureData:
        if not self.values:
            self.add((1.0, 1.0, 1.0))
        return TextureData(kind=np.zeros(len(self.values), np.int32),
                           value=np.stack(self.values).astype(np.float32),
                           n=len(self.values), kinds_present=(CONST,))


def check_supported(tex: Optional[TextureData]):
    if tex is not None and set(tex.kinds_present) - {CONST}:
        raise NotImplementedError(
            "only constant textures are ported; image and procedural "
            "textures are queued (ROADMAP Queue 1 item 6, textures)")


def evaluate(tex: TextureData, tid, it):
    """Texture value per lane (constant textures): V3."""
    check_supported(tex)
    tid = tid.clamp_min(0).long()
    return vm.V3(tex.value[:, 0][tid], tex.value[:, 1][tid],
                 tex.value[:, 2][tid])


def eval_or(tex: Optional[TextureData], tid, it, fallback):
    """Evaluate textures where tid >= 0, else use fallback (V3)."""
    if tex is None:
        return fallback
    return vm.where3(tid >= 0, evaluate(tex, tid, it), fallback)


def eval_or_scalar(tex: Optional[TextureData], tid, it, fallback):
    """Scalar-parameter texture override: first channel, (R,) in/out."""
    if tex is None:
        return fallback
    return torch.where(tid >= 0, evaluate(tex, tid, it).x, fallback)
