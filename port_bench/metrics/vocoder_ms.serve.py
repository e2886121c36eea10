"""vocoder_ms.serve: device ms of the vocoder (``vm.from_features``) a call, by
CUDA events recorded around it in the window, mean over the window's calls."""


def read(layer: dict):
    ms = layer.get("vocoder_ms")
    return sum(ms) / len(ms) if ms else None
