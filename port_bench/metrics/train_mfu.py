"""train_mfu: the model operations of the traced micro-batches
(``roofline.gan_step_ops``: the generator's forward and backward, the
discriminators in the generator's step and in their own), over the traced
window times the bfloat16 peak (the recipe trains under bf16 autocast), in %."""

from port_bench import roofline


def read(layer: dict):
    tr, n = layer.get("trace"), layer.get("micro_batches")
    if tr is None or not n or tr.window_s <= 0:
        return None
    cfg = layer["config"]
    ops = n * roofline.gan_step_ops(cfg["generator"], cfg["discriminator"], layer["rows"],
                                    layer["samples"])
    return 100.0 * ops / (tr.window_s * roofline.PEAK_OPS["bfloat16"])
