"""convnext_roofline.infer: the ConvNeXt block kernels' share of their
least time at the step's shapes."""
from port_bench.yardstick import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "convnext")
