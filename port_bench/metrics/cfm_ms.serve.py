"""cfm_ms.serve: device ms of the kernels launched inside the program's
``tts.cfm`` span (the Euler loop of ``CFMDecoder.generate``) a call, in the
traced window."""

from port_bench import spans


def read(layer: dict):
    return spans.per_call_ms(layer, "tts.cfm")
