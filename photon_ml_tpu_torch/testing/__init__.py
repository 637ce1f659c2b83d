"""Seeded synthetic data for the port's tests and ``chip_smoke.py``: the
JAX package's ``testing/generators.py``, copied."""

from .generators import (
    generate_game_records,
    generate_glm_data,
    generate_mixed_effect_data,
    mixed_data_to_raw_dataset,
)

__all__ = [
    "generate_glm_data",
    "generate_mixed_effect_data",
    "generate_game_records",
    "mixed_data_to_raw_dataset",
]
