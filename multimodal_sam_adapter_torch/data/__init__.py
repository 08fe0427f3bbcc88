"""Datasets, pipelines and the loader of the port (its own copies of the
JAX package's `data/`)."""
from .datasets import DELIVER, FMB, MUSES, build_dataset
from .loader import DataLoader
from .pipelines import TestPipeline, TrainPipeline, load_multimodal_image

__all__ = ["DELIVER", "FMB", "MUSES", "build_dataset", "DataLoader",
           "TestPipeline", "TrainPipeline", "load_multimodal_image"]
