"""attention_op_roofline.serve: attention_roofline.serve's bound (the least time
of the traced calls' attention) over the device time of the kernels launched
inside the program's ``op.attention`` spans, whatever kernels implement the op,
in %."""

from port_bench import spans


def read(layer: dict):
    return spans.roofline_share(layer, spans.attention_bound_s, ("op.attention",))
