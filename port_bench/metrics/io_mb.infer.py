"""io_mb.infer: MB copied between host and device under `msa.predict.h2d`
and `msa.predict.d2h` a served frame."""
from port_bench.phases import io_mb_per_image as read  # noqa: F401
