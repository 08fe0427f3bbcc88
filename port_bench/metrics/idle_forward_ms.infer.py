"""idle_forward_ms.infer: device idle ms a step under the program's
`msa.predict.forward` span (the host dispatching the model)."""
from port_bench.phases import idle_ms


def read(ctx):
    return idle_ms(ctx, "msa.predict", ("msa.predict.forward",))
