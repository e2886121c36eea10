"""acoustic_ms.serve: device ms of the acoustic model's inference call
(``am.inference``) a call, by CUDA events recorded around it in the window,
mean over the window's calls."""


def read(layer: dict):
    ms = layer.get("acoustic_ms")
    return sum(ms) / len(ms) if ms else None
