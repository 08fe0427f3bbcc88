"""Data parallelism across processes (parallel/ddp.py)."""
from .ddp import (all_reduce_sum, barrier, close_distributed,
                  init_distributed, is_main, rank_device, rank_world,
                  wrap_model)

__all__ = ["all_reduce_sum", "barrier", "close_distributed",
           "init_distributed", "is_main", "rank_device", "rank_world",
           "wrap_model"]
