"""anti_alias_vjp_ms.train: device ms a micro-batch of the kernels launched while
the backward of one of the anti-aliased snake's autograd nodes below ran (the
node's own ``<node>Backward`` range), in the traced accumulation cycle."""

NODES = ("_AntiAliasSnakeFn", "_UpsampleFirFn", "_SnakeDownsampleFn")


def read(layer: dict):
    tr, n = layer.get("trace"), layer.get("micro_batches")
    if tr is None or not n:
        return None
    s = tr.under_nodes_s(NODES)
    return 1e3 * s / n if s > 0 else None
