from .data import RawDataset

__all__ = ["RawDataset"]
