"""Datasets and the test pipeline of the port (its own copies of the JAX
package's `data/`, test time only)."""
from .datasets import DELIVER, FMB, MUSES, build_dataset
from .pipelines import TestPipeline, load_multimodal_image

__all__ = ["DELIVER", "FMB", "MUSES", "build_dataset", "TestPipeline",
           "load_multimodal_image"]
