"""launches.infer: device kernels a step."""
from port_bench.yardstick import launches_per_step as read  # noqa: F401
