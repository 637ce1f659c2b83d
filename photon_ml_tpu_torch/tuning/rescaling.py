"""Hyperparameter vector rescaling: unit hypercube <-> native ranges.

Reference: photon-lib .../hyperparameter/VectorRescaling.scala:28-150 —
linear or log10 scaling per dimension plus discrete-dimension rounding, and
the HyperparameterConfig JSON shape (name/type/min/max per parameter).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

TRANSFORM_NONE = "NONE"
TRANSFORM_LOG = "LOG"
TRANSFORM_SQRT = "SQRT"


@dataclasses.dataclass(frozen=True)
class ParamRange:
    name: str
    min: float
    max: float
    transform: str = TRANSFORM_NONE  # NONE | LOG (log10 space) | SQRT
    discrete: bool = False

    def _fwd(self, v):
        if self.transform == TRANSFORM_LOG:
            return np.log10(v)
        if self.transform == TRANSFORM_SQRT:
            return np.sqrt(v)
        return v

    def _bwd(self, v):
        if self.transform == TRANSFORM_LOG:
            return 10.0 ** v
        if self.transform == TRANSFORM_SQRT:
            return v * v
        return v

    def scale_up(self, unit: float) -> float:
        """[0,1] -> native."""
        lo, hi = self._fwd(self.min), self._fwd(self.max)
        v = self._bwd(lo + unit * (hi - lo))
        if self.discrete:
            v = float(np.round(v))
        return float(v)

    def scale_down(self, value: float) -> float:
        """native -> [0,1]."""
        lo, hi, v = self._fwd(self.min), self._fwd(self.max), self._fwd(value)
        return float(np.clip((v - lo) / (hi - lo) if hi > lo else 0.0, 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class HyperparameterConfig:
    """Tuning problem description (HyperparameterSerialization.scala:27-136)."""

    params: Sequence[ParamRange]

    @property
    def dim(self) -> int:
        return len(self.params)

    def scale_up(self, unit_vec: np.ndarray) -> np.ndarray:
        return np.asarray([p.scale_up(u) for p, u in zip(self.params, unit_vec)])

    def scale_down(self, native_vec: np.ndarray) -> np.ndarray:
        return np.asarray([p.scale_down(v) for p, v in zip(self.params, native_vec)])

    def discrete_dims(self) -> Dict[int, int]:
        out = {}
        for i, p in enumerate(self.params):
            if p.discrete:
                out[i] = int(p.max - p.min) + 1
        return out

    @staticmethod
    def from_json(text: str) -> "HyperparameterConfig":
        obj = json.loads(text)
        params = [
            ParamRange(
                name=p["name"],
                min=float(p["min"]),
                max=float(p["max"]),
                transform=p.get("transform", TRANSFORM_NONE).upper(),
                discrete=bool(p.get("discrete", False)),
            )
            for p in obj["variables"] if isinstance(obj, dict) and "variables" in obj
        ] if isinstance(obj, dict) and "variables" in obj else [
            ParamRange(**p) for p in obj
        ]
        return HyperparameterConfig(params=params)

    def to_json(self) -> str:
        return json.dumps(
            {
                "variables": [
                    {
                        "name": p.name,
                        "min": p.min,
                        "max": p.max,
                        "transform": p.transform,
                        "discrete": p.discrete,
                    }
                    for p in self.params
                ]
            }
        )
