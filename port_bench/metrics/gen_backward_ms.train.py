"""gen_backward_ms.train: device ms a micro-batch of the kernels launched inside
the program's ``gan.gen.backward`` span (the backward of the generator's losses,
the anti-alias VJPs in it), in the traced accumulation cycle."""

from port_bench import spans


def read(layer: dict):
    return spans.per_micro_batch_ms(layer, ("gan.gen.backward",))
