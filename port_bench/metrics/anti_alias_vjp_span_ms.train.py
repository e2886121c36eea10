"""anti_alias_vjp_span_ms.train: device ms a micro-batch from the first kernel to
the last of each of the program's three anti-alias VJP spans (``op.aa_snake.vjp``,
``op.aa_upsample.vjp``, ``op.aa_snake_down.vjp``), summed over the traced
accumulation cycle: the gaps between a VJP's kernels count, as the profiler's
host cost leaves them."""

from port_bench import spans


def read(layer: dict):
    return spans.per_micro_batch_ms(layer, spans.AA_VJP, elapsed=True)
