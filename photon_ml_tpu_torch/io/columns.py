"""Remappable reserved input-column names.

Reference: photon-api .../data/InputColumnsNames.scala:29-106 — the reserved
columns (uid, response, offset, weight, metadataMap) can be remapped by the
user so production datasets with different field names read without a
rewrite. RESPONSE (plus feature bags) is required; everything else is
optional. Column names must be unique.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

UID = "uid"
RESPONSE = "response"
OFFSET = "offset"
WEIGHT = "weight"
META_DATA_MAP = "metadataMap"

ALL = (UID, RESPONSE, OFFSET, WEIGHT, META_DATA_MAP)


@dataclasses.dataclass(frozen=True)
class InputColumnsNames:
    """column-key -> actual field name in the input records."""

    names: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: {k: k for k in ALL}
    )

    def __post_init__(self):
        unknown = set(self.names) - set(ALL)
        if unknown:
            raise ValueError(f"unknown input columns {sorted(unknown)}; expected {ALL}")
        full = {**{k: k for k in ALL}, **dict(self.names)}
        if len(set(full.values())) != len(full):
            raise ValueError(f"each column must have a unique name: {full}")
        object.__setattr__(self, "names", full)

    def __getitem__(self, key: str) -> str:
        return self.names[key]

    @staticmethod
    def from_spec(spec: str) -> "InputColumnsNames":
        """Parse 'response=label,weight=importance' CLI grammar."""
        custom: Dict[str, str] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            if not value:
                raise ValueError(f"bad input-column mapping {part!r}; want key=name")
            custom[key.strip()] = value.strip()
        return InputColumnsNames(names=custom)
