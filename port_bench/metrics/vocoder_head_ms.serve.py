"""vocoder_head_ms.serve: device ms of the kernels launched inside the program's
``vocoder.head`` span (the head's call in ``Vocos.from_features``) a call, in the
traced window."""

from port_bench import spans


def read(layer: dict):
    return spans.per_call_ms(layer, "vocoder.head")
