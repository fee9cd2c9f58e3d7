"""Training data: JSON/JSONL datasets, batching and prefetch."""

from .dataset import IPADataset, PrefetchLoader, create_data_loader

__all__ = ["IPADataset", "PrefetchLoader", "create_data_loader"]
