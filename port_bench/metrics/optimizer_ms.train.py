"""optimizer_ms.train: device ms a micro-batch of the kernels launched inside the
program's ``optim.step`` spans (both optimizers: the accumulation every
micro-batch; at the cycle's last the finiteness check, the clip and AdamW), over
the traced cycle, which is one whole accumulation cycle."""

from port_bench import spans


def read(layer: dict):
    return spans.per_micro_batch_ms(layer, ("optim.step",))
