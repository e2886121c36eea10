"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated()`` over the window,
after a reset at its start, in GiB."""


def read(layer: dict):
    peak = layer.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
