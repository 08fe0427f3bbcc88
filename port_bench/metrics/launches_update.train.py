"""launches_update.train: kernels a micro-step launched under
`msa.train_step.update` (the optimizer's step: every accumulation's last
micro-step updates)."""
from port_bench.phases import per_step


def read(ctx):
    return per_step(ctx, "kernels", "msa.train_step",
                    ("msa.train_step.update",))
