"""idle_backward_ms.train: device idle ms a micro-step under the program's
`msa.train_step.backward` span."""
from port_bench.phases import idle_ms


def read(ctx):
    return idle_ms(ctx, "msa.train_step", ("msa.train_step.backward",))
