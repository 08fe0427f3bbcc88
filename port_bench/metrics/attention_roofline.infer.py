"""attention_roofline.infer: the rel-pos attention kernels' (windowed and
global) share of their least time at the step's shapes."""
from port_bench.yardstick import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "attention")
