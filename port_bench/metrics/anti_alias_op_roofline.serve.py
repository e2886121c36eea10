"""anti_alias_op_roofline.serve: anti_alias_roofline.serve's bound (the least
time of every activation of the vocoder's head over the traced calls' valid
frames) over the device time of the kernels launched inside the program's three
anti-alias forward spans (``op.aa_snake``, ``op.aa_upsample``,
``op.aa_snake_down``), whatever kernels implement them, in %."""

from port_bench import spans


def read(layer: dict):
    return spans.roofline_share(layer, spans.head_activation_bound_s, spans.AA_FORWARD)
