"""The optimizer state of a JAX checkpoint onto the port's ``Optimizer``.

The JAX trainers save ``nnx.state(nnx.Optimizer)`` as a pure dict; its
``opt_state`` is the state of the chain ``training.optimizer`` builds:

    MultiSteps(apply_if_finite(chain(clip_by_global_norm, chain(base, windows))))

with ``MultiSteps`` only when ``grad_accum > 1``, the clip only with
``grad_clip`` and the windows' gate only with ``param_groups``. Its leaves map
onto the port's state by the ``/``-joined parameter paths of
``convert.nnx_path``, in the parameters' torch layout:

- ``ScaleByAdamState`` (adam, adamw, lamb): ``mu`` / ``nu`` become torch's
  ``exp_avg`` / ``exp_avg_sq`` (the port's ``Lamb``: ``mu`` / ``nu``) and its
  ``count``, the number of applied steps, each parameter's ``step``;
- ``sgd``'s momentum ``trace`` becomes ``momentum_buffer``;
- adafactor's ``FactoredState``: ``v_row`` / ``v_col`` of a factored parameter,
  ``v`` of another, kept as they are (the port's ``Adafactor`` holds its state
  in the JAX layout, ``convert.jax_layouts``), each checked against the shape
  optax gives that parameter; the ``(1,)`` placeholders of the other entries
  are checked and not stored; its ``count`` becomes each parameter's ``step``;
- the learning-rate schedule's count (and the windows' gate count) becomes
  ``count``; all these counts must agree;
- ``MultiSteps``' ``mini_step`` and ``acc_grads`` become ``mini_step`` and
  ``acc`` (a half-done accumulation carries over);
- ``apply_if_finite``'s ``notfinite_count`` becomes ``notfinite_count``.

A tree this map does not cover raises by name (a missing entry, a parameter
with no moment, an entry of the wrong shape, a method whose state is not
mapped); moments are never restarted from zero in silence.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from speechflow_torch.convert import flatten_nnx, state_dict_from_nnx

__all__ = ["is_optax_state", "load_optax_state"]

# the index of the learning-rate scale in each base chain of optax
_SCHEDULE_INDEX = {"adamw": 2, "adam": 1, "lamb": 3, "sgd": 1, "adafactor": 2}
_FACTORED = ("v_row", "v_col", "v")


def is_optax_state(state: tp.Any) -> bool:
    """Whether ``state`` is a JAX trainer's optimizer tree (not the port's)."""
    return isinstance(state, tp.Mapping) and "opt_state" in state


def _child(node: tp.Any, key: tp.Union[str, int], path: str) -> tp.Any:
    """``node[key]`` for a dict (string or integer keys, as orbax or nnx give
    them) or a list; KeyError naming the path where it is absent."""
    here = f"{path}/{key}" if path else str(key)
    if isinstance(node, (list, tuple)) and str(key).isdigit() and int(key) < len(node):
        value = node[int(key)]
    elif isinstance(node, tp.Mapping):
        for k in (key, str(key), int(key) if str(key).isdigit() else None):
            if k is not None and k in node:
                value = node[k]
                break
        else:
            raise KeyError(f"optax state: no {here!r} in the checkpoint's optimizer tree")
    else:
        raise KeyError(f"optax state: no {here!r} in the checkpoint's optimizer tree")
    if value is None:
        raise KeyError(f"optax state: {here!r} is empty")
    return value


def _walk(node: tp.Any, path: str, *keys) -> tp.Tuple[tp.Any, str]:
    for k in keys:
        node = _child(node, k, path)
        path = f"{path}/{k}" if path else str(k)
    return node, path


def _int(value) -> int:
    return int(np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value))


def _port_layout(module, tree: tp.Mapping, what: str) -> tp.Dict[str, torch.Tensor]:
    """A tree of the parameters' shape in the port's names and layout (strict
    both ways, as ``convert``)."""
    try:
        return state_dict_from_nnx(module, tree)
    except (KeyError, ValueError) as e:
        raise KeyError(f"optax state {what}: {e}") from e


def _factored_state(opt, trees: tp.Mapping[str, tp.Any], path: str
                    ) -> tp.Dict[str, tp.Dict[str, torch.Tensor]]:
    """Adafactor's ``v_row`` / ``v_col`` / ``v`` trees -> entry -> port name ->
    tensor in JAX's layout, only the entries the optimizer keeps for that
    parameter (the others must be optax's ``(1,)`` placeholders); strict both
    ways, every entry checked against the shape optax gives it."""
    from speechflow_torch.convert import jax_layouts

    flat = {k: flatten_nnx(v) for k, v in trees.items()}
    layouts = jax_layouts(opt.module)
    out: tp.Dict[str, tp.Dict[str, torch.Tensor]] = {k: {} for k in _FACTORED}
    used = set()
    for name, p in opt.module.named_parameters():
        src = layouts[name][0]
        want = opt.base.state_shapes(p)
        for k in _FACTORED:
            if src not in flat[k]:
                raise KeyError(f"optax state: no {path}/{k}/{src.replace('.', '/')!r} in the "
                               "checkpoint's optimizer tree")
            arr = flat[k][src]
            shape = want.get(k, (1,))
            if tuple(arr.shape) != shape:
                raise ValueError(f"optax state {path}/{k}: {src} is {arr.shape}, optax gives "
                                 f"{shape} for the parameter {name}")
            if k in want:
                out[k][name] = torch.from_numpy(np.ascontiguousarray(arr))
        used.add(src)
    for k, leaves in flat.items():
        unused = sorted(set(leaves) - used)
        if unused:
            raise KeyError(f"optax state {path}/{k}: entries with no parameter in the port: "
                           f"{unused}")
    return out


def load_optax_state(opt, tree: tp.Mapping) -> None:
    """Set ``opt`` (a ``training.optimizer.Optimizer`` over ``opt.module``) to
    the state of the JAX ``nnx.Optimizer`` pure dict ``tree``, built with the
    same ``OptimizerConfig``."""
    cfg = opt.cfg
    if cfg.method not in _SCHEDULE_INDEX:
        raise NotImplementedError(f"optax state of method {cfg.method!r} is not mapped onto "
                                  "the port's optimizer")
    node, path = _walk(tree, "", "opt_state")
    mini_step, acc_tree = 0, None
    if cfg.grad_accum > 1:
        mini_step = _int(_walk(node, path, "mini_step")[0])
        acc_tree = _walk(node, path, "acc_grads")[0]
        node, path = _walk(node, path, "inner_opt_state")
    notfinite = _int(_walk(node, path, "notfinite_count")[0])
    node, path = _walk(node, path, "inner_state")
    if cfg.grad_clip:
        node, path = _walk(node, path, 1)
    counts = {}
    if cfg.param_groups:
        counts["windows"] = _int(_walk(node, path, 1, "count")[0])
        node, path = _walk(node, path, 0)
    counts["schedule"] = _int(_walk(node, path, _SCHEDULE_INDEX[cfg.method], "count")[0])
    first, first_path = _walk(node, path, 0)
    if cfg.method == "adafactor":
        counts["factored"] = _int(_walk(first, first_path, "count")[0])
        moments = {k: _walk(first, first_path, k)[0] for k in _FACTORED}
    elif cfg.method == "sgd":
        moments = {"momentum_buffer": _walk(first, first_path, "trace")[0]}
    else:
        counts["adam"] = _int(_walk(first, first_path, "count")[0])
        names = ("mu", "nu") if cfg.method == "lamb" else ("exp_avg", "exp_avg_sq")
        moments = {names[0]: _walk(first, first_path, "mu")[0],
                   names[1]: _walk(first, first_path, "nu")[0]}
    if len(set(counts.values())) != 1:
        raise ValueError(f"optax state: the step counts disagree: {counts}")
    count = counts["schedule"]

    if cfg.method == "adafactor":
        by_name = _factored_state(opt, moments, first_path)
    else:
        by_name = {k: _port_layout(opt.module, v, f"{first_path}:{k}")
                   for k, v in moments.items()}
    with torch.no_grad():
        opt.base.state.clear()
        for name, p in zip(opt.names, opt.params):
            st = {k: sd[name].to(p.device, p.dtype) for k, sd in by_name.items()
                  if name in sd}
            if cfg.method in ("lamb", "adafactor"):
                st["step"] = count
            elif cfg.method != "sgd":
                st["step"] = torch.tensor(float(count), dtype=torch.float32)
            opt.base.state[p] = st
        opt.acc = None
        if mini_step:
            acc = _port_layout(opt.module, acc_tree, "opt_state/acc_grads")
            opt.acc = [acc[name].to(p.device, p.dtype) for name, p in zip(opt.names, opt.params)]
    opt.count, opt.mini_step, opt.notfinite_count = count, mini_step, notfinite
