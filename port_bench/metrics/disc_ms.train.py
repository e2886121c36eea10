"""disc_ms.train: device ms a micro-batch of the kernels launched inside the
program's ``gan.disc`` span (the discriminator's losses and their backward), in
the traced accumulation cycle."""

from port_bench import spans


def read(layer: dict):
    return spans.per_micro_batch_ms(layer, ("gan.disc",))
