"""mfu.train: the step's share of the bf16 tensor-core peak."""
from port_bench.yardstick import mfu_percent as read  # noqa: F401
