"""The single-image inference API of the port (apis/inference.py)."""
from .inference import (SegmentorHandle, inference_segmentor, init_segmentor,
                        show_result_pyplot)

__all__ = ["SegmentorHandle", "init_segmentor", "inference_segmentor",
           "show_result_pyplot"]
