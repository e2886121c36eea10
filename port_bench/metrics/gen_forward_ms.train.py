"""gen_forward_ms.train: device ms a micro-batch of the kernels launched inside
the program's ``gan.gen.forward`` span (the generator's call under autocast and
the cast of its output), in the traced accumulation cycle."""

from port_bench import spans


def read(layer: dict):
    return spans.per_micro_batch_ms(layer, ("gan.gen.forward",))
