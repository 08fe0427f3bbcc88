"""idle_share.train: the share of a step's time the device is idle."""
from port_bench.yardstick import idle_percent as read  # noqa: F401
