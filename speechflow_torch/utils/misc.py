"""Version checks, the visible CUDA devices and checkpoint pruning (counterpart
of ``speechflow_tpu/utils/misc.py``).

``version_check`` parses a version as JAX's does: the leading dot-separated
fields that are all digits, up to three, so ``"2.13.0+cpu"`` reads as (2, 13)
(its last field is ``0+cpu``), which compares below a minimum of ``2.13.0``
(ROADMAP §3: the port keeps JAX's reading). ``cuda_info`` is the counterpart of
``tpu_info``: one dict a visible CUDA device, in the same keys.
``prune_checkpoint`` reads a checkpoint of either package and writes the port's
layout without the optimizer state and the payload's ``sources``.
"""

from __future__ import annotations

import logging
import typing as tp
from pathlib import Path

__all__ = ["version_check", "cuda_info", "prune_checkpoint", "find_free_port"]


def version_check(module, minimum: str, name: tp.Optional[str] = None) -> bool:
    """Warn when a dependency is older than the tested minimum."""
    have = tuple(int(x) for x in str(getattr(module, "__version__", "0")).split(".")[:3]
                 if x.isdigit())
    want = tuple(int(x) for x in minimum.split(".")[:3])
    ok = have >= want
    if not ok:
        logging.getLogger("speechflow_torch").warning(
            "%s %s < required %s", name or module.__name__, have, minimum)
    return ok


def cuda_info() -> tp.List[dict]:
    """The visible CUDA devices: id, platform ``gpu``, kind (the device's name),
    bytes in use and the device's total (None where not known); [] without one."""
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({"id": i, "platform": "gpu", "kind": props.name,
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "bytes_limit": props.total_memory})
    return out


def _numpy_leaves(node: tp.Any) -> tp.Any:
    """A tree with its tensor leaves as numpy (a bfloat16 one as float32)."""
    import numpy as np
    import torch

    if isinstance(node, tp.Mapping):
        return {k: _numpy_leaves(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        node = node.detach().cpu()
        return (node.float() if node.dtype == torch.bfloat16 else node).numpy()
    return np.asarray(node)


def prune_checkpoint(ckpt_path: tp.Union[str, Path], out_path: tp.Union[str, Path],
                     drop_optimizer: bool = True, drop_sources: bool = True) -> Path:
    """A checkpoint for distribution: the weights, step and payload (configs,
    alphabet, singletons) of ``ckpt_path`` (either package's layout) written to
    ``out_path`` in the port's, without the optimizer state and the payload's
    ``sources`` (each kept on request)."""
    from speechflow_torch.training.saver import ExperimentSaver

    tree, payload = ExperimentSaver.load_checkpoint(ckpt_path)
    opt = None if drop_optimizer else tree.get("opt")
    if drop_sources:
        payload = {k: v for k, v in payload.items() if k != "sources"}
    return ExperimentSaver.write_checkpoint(out_path, int(tree.get("step", 0)),
                                            _numpy_leaves(tree["model"]), opt, payload)


def find_free_port() -> int:
    """A free TCP port on the loopback interface."""
    from speechflow_torch.server.transport import find_free_port as _free

    return _free()
