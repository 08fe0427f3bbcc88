"""idle_engine_ms.infer: device idle ms a step under `msa.predict` outside
its forward: the crop stack, the H2D, the post-processing, the D2H and the
root's own time."""
from port_bench.phases import idle_ms

ENGINE = ("msa.predict", "msa.predict.stage", "msa.predict.h2d",
          "msa.predict.post", "msa.predict.d2h")


def read(ctx):
    return idle_ms(ctx, "msa.predict", ENGINE)
