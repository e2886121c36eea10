"""gen_loss_ms.train: device ms a micro-batch of the kernels launched inside the
program's ``gan.gen.loss`` span (the generator's criterion and its sum: both
discriminators, mel, STFT, feature matching), in the traced accumulation cycle."""

from port_bench import spans


def read(layer: dict):
    return spans.per_micro_batch_ms(layer, ("gan.gen.loss",))
