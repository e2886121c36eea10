"""Every public name and keyword of the JAX package has a counterpart of the
same name in the port, or an entry in ``LEFT_OUT`` with its reason.

Both trees are parsed with ``ast``; neither package is imported. For each
``speechflow_tpu/<path>.py`` (one test case a module) the public items are:

- module-level functions and classes (no leading ``_``) and UPPER constants;
- each class's public methods and properties;
- the keyword parameters (``self``/``cls`` and ``_``-names aside) of each
  public function and method, and of each class: its ``__init__``'s, or for a
  dataclass or params class without one, its annotated fields.

Each must exist in ``speechflow_torch/<path>.py``: a module-level binding of
the name (a definition, an assignment or an import); a class's method,
property, class attribute or ``self.<name>`` attribute, its own or a port base
class's; a parameter of the counterpart callable (a class's ``__init__``, or
its dataclass fields, its own or a port base class's). A name the port binds
to an expression that is not a class or a function is taken as it is.

``LEFT_OUT`` keys are ``<path>::<Name>``, ``<path>::<Class>.<member>``,
``<path>::<callable>(<keyword>)`` or ``*(<keyword>)`` (that keyword of every
callable). A key that matches nothing missing fails too, so the table cannot
go stale when the port gains the item.
"""

import ast
import re
import typing as tp
from functools import lru_cache
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "speechflow_tpu", REPO / "speechflow_torch"
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

_ZMQ = ("pyzmq, which the card's machine lacks: the port's data plane and log "
        "transport are the standard library's sockets (server/transport.py, "
        "logging/server.py::attach_socket_handler)")
_NATIVE = ("the JAX package's host C++ pad-and-stack (native/), not a TPU kernel; "
           "utils/pad.py gives the same arrays")

_KEY = "a JAX PRNG key; the port takes a torch.Generator or injected draws"

LEFT_OUT: tp.Dict[str, str] = {
    # packages or weights the card's machine lacks
    "logging/server.py::ZMQPushHandler": _ZMQ,
    "logging/server.py::attach_zmq_handler": _ZMQ,
    "server/helpers.py::local_ipc_addr": _ZMQ,
    "server/proxy.py::Proxy.batch_preprocessing(batch_blob)": (
        "pyzmq framing: JAX's hook gets the ZMQ frame's bytes; the port's socket "
        "transport hands it the collated batch (``collated``)"),
    # JAX, XLA or TPU only
    "*(rngs)": "flax's nnx.Rngs streams; the port's modules draw from torch generators "
               "or take injected draws",
    "utils/seed.py::jax_key": "makes a JAX PRNG key from a seed",
    "models/aligner/model.py::GlowTTSAligner.generate(key)": _KEY,
    "models/tts/ar_decoders.py::GPTDecoder.generate(key)": _KEY,
    "models/tts/ar_decoders.py::GPTDecoder.generate_naive(key)": _KEY,
    "models/tts/decoders.py::CFMDecoder.generate(key)": _KEY,
    "models/tts/predictors.py::GaussianMixtureVAE.sample_prior(key)": _KEY,
    "models/tts/xtts.py::XTTSModel.synthesize(key)": _KEY,
    "ops/signal.py::dither(key)": _KEY,
    "utils/misc.py::tpu_info": "reads the TPU runtime's device info",
    "utils/misc.py::enable_compilation_cache": "XLA's persistent compilation cache",
    "training/trainer.py::set_compute_dtype": (
        "JAX's global compute dtype; the port casts with autocast per call"),
    "ops/attention.py::use_flash_attention": (
        "switches flax's attention_fn to the Pallas kernel; the port always calls "
        "its CUDA kernel"),
    "ops/attention.py::flash_attention_fn(bias)": "flax's attention_fn contract",
    "ops/attention.py::flash_attention_fn(broadcast_dropout)": "flax's attention_fn contract",
    "ops/attention.py::flash_attention_fn(dropout_rng)": "flax's attention_fn contract",
    "ops/attention.py::flash_attention_fn(dtype)": "flax's attention_fn contract",
    "ops/attention.py::flash_attention_fn(precision)": "flax's attention_fn contract (XLA)",
    "ops/attention.py::flash_attention_fn(module)": "flax's attention_fn contract",
    "ops/attention.py::flash_attention_fn(promote_dtype)": "flax's attention_fn contract",
    "ops/attention.py::flash_attention_fn(is_causal)": "flax's attention_fn contract",
    "ops/anti_alias.py::anti_alias_snake_pallas": (
        "the Pallas TPU kernel; the port's is csrc/anti_alias.cu behind anti_alias_snake"),
    "ops/anti_alias.py::anti_alias_snake_xla": (
        "the XLA composition JAX's remat=False path takes; the port's plain version is "
        "anti_alias_snake_reference"),
    "ops/anti_alias.py::anti_alias_snake(remat)": (
        "jax.custom_vjp's recompute switch; the port's autograd Function always keeps "
        "only its inputs, and models/vocoder/heads.py checkpoints its plain version "
        "(remat= there)"),
    "ops/folded.py::fold_shift": "the TPU lane-layout shift of the folded head",
    "ops/folded.py::fold(F)": "the TPU lane-layout fold factor (the port's is C)",
    "ops/folded.py::unfold(C)": "the TPU lane-layout fold keyword",
    "ops/folded.py::fold_conv_kernel(F)": "the TPU lane-layout fold factor",
    "ops/folded.py::fold_conv_transpose_kernel(F)": "the TPU lane-layout fold factor",
    "ops/folded.py::folded_aa_upsample_fir(C)": "the TPU lane-layout fold keyword",
    "ops/folded.py::folded_aa_snake_downsample(C)": "the TPU lane-layout fold keyword",
    "ops/folded.py::folded_anti_alias_snake(C)": "the TPU lane-layout fold keyword",
    "scripts/common.py::config_prepare": (
        "JAX's config, mesh and compilation-cache set-up; the port's scripts read "
        "their YAML through configs()"),
    "models/ssl/cpc.py::optax_softmax_ce": "optax's softmax cross-entropy",
    "training/optimizer.py::build_optimizer(params_example)": (
        "optax builds a GradientTransformation before any parameter exists and needs a "
        "pytree example; the port's Optimizer takes the module"),
    "parallel/mesh.py::make_mesh(devices)": "a jax.sharding Mesh over JAX devices",
    "parallel/mesh.py::replicate_state(state)": "places an nnx state on a JAX mesh",
    # the host C++ helper
    "utils/native.py::LOGGER": _NATIVE,
    "utils/native.py::native_available": _NATIVE,
    "utils/native.py::native_pack": _NATIVE,
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn) -> tp.List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls") and _public(x.arg)]


@lru_cache(maxsize=None)
def _tree(path: Path) -> tp.Optional[ast.Module]:
    return ast.parse(path.read_text(), str(path)) if path.exists() else None


def _bindings(tree: ast.Module) -> tp.Dict[str, ast.AST]:
    """Module-level names (also those bound inside a module-level if/try)."""
    out: tp.Dict[str, ast.AST] = {}
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.setdefault(node.name, node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.setdefault(n.id, node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.setdefault(node.target.id, node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], node)
        elif isinstance(node, (ast.If, ast.Try)):
            todo.extend(node.body + node.orelse + getattr(node, "finalbody", [])
                        + [s for h in getattr(node, "handlers", []) for s in h.body])
    return out


def _module_file(module: str) -> tp.Optional[Path]:
    if not module.startswith("speechflow_torch"):
        return None
    base = REPO / Path(*module.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _resolve(path: Path, name: str, depth: int = 0) -> tp.Optional[ast.AST]:
    """The port's definition (def or class) that ``name`` is bound to in
    ``path``, following imports and plain aliases; the binding itself when it
    is an expression."""
    tree = _tree(path)
    node = _bindings(tree).get(name) if tree else None
    if node is None or depth > 8:
        return None
    if isinstance(node, ast.ImportFrom):
        for a in node.names:
            if (a.asname or a.name) == name:
                module = node.module or ""
                if node.level:
                    pkg = path.parent
                    for _ in range(node.level - 1):
                        pkg = pkg.parent
                    module = ".".join(pkg.relative_to(REPO).parts + tuple(
                        module.split(".") if module else ()))
                target = _module_file(module)
                if target is None:  # a submodule imported by name
                    target = _module_file(f"{module}.{a.name}")
                    return node if target else None
                return _resolve(target, a.name, depth + 1) or node
    if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
            and node.value.id != name:
        return _resolve(path, node.value.id, depth + 1) or node
    return node


def _base_classes(path: Path, cls: ast.ClassDef) -> tp.List[tp.Tuple[Path, ast.ClassDef]]:
    out = []
    for b in cls.bases:
        name = b.id if isinstance(b, ast.Name) else None
        if name is None:
            continue
        found = _resolve(path, name)
        if isinstance(found, ast.ClassDef):
            out.append((_definition_file(path, name), found))
    return out


def _definition_file(path: Path, name: str) -> Path:
    """The file where ``name`` (bound in ``path``) is defined."""
    node = _bindings(_tree(path)).get(name)
    if isinstance(node, ast.ImportFrom):
        for a in node.names:
            if (a.asname or a.name) == name and node.module:
                target = _module_file(node.module)
                if target is not None:
                    return _definition_file(target, a.name)
    return path


def _fields(cls: ast.ClassDef) -> tp.List[str]:
    return [n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            and "ClassVar" not in ast.unparse(n.annotation)]


def _members(path: Path, cls: ast.ClassDef) -> tp.Set[str]:
    names: tp.Set[str] = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    for node in ast.walk(cls):
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        names.update(t.attr for t in targets if isinstance(t, ast.Attribute)
                     and isinstance(t.value, ast.Name) and t.value.id == "self")
    for bpath, base in _base_classes(path, cls):
        names |= _members(bpath, base)
    return names


def _method(path: Path, cls: ast.ClassDef, name: str):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name == name:
            return node
    for bpath, base in _base_classes(path, cls):
        found = _method(bpath, base, name)
        if found is not None:
            return found
    return None


def _init_params(path: Path, cls: ast.ClassDef) -> tp.List[str]:
    init = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                 and n.name == "__init__"), None)
    if init is not None:
        return _params(init)
    inherited: tp.List[str] = []
    for bpath, base in _base_classes(path, cls):
        inherited += _init_params(bpath, base)
    return inherited + _fields(cls)


def _jax_items(rel: str) -> tp.List[tp.Tuple[str, str, tp.Optional[str]]]:
    """(kind, item key, the port's name path) of every public item: kinds
    ``name``, ``member`` and ``keyword``."""
    items = []
    tree = _tree(JAX / rel)
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            items += [("name", f"{rel}::{t.id}", t.id) for t in targets
                      if isinstance(t, ast.Name) and UPPER.match(t.id)]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            items.append(("name", f"{rel}::{node.name}", node.name))
            items += [("keyword", f"{rel}::{node.name}({k})", k) for k in _params(node)]
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            items.append(("name", f"{rel}::{node.name}", node.name))
            init = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if sub.name == "__init__":
                        init = _params(sub)
                    elif _public(sub.name):
                        key = f"{rel}::{node.name}.{sub.name}"
                        items.append(("member", key, sub.name))
                        items += [("keyword", f"{key}({k})", k) for k in _params(sub)]
            for k in init if init is not None else [f for f in _fields(node) if _public(f)]:
                items.append(("keyword", f"{rel}::{node.name}({k})", k))
    return items


def _missing(rel: str) -> tp.List[str]:
    port_file = PORT / rel
    if _tree(port_file) is None:
        return [key for _, key, _ in _jax_items(rel)]
    out = []
    for kind, key, name in _jax_items(rel):
        owner = key.split("::", 1)[1].split("(")[0]
        top = owner.split(".")[0]
        found = _resolve(port_file, top)
        if found is None:
            out.append(key)
            continue
        fpath = _definition_file(port_file, top)
        if kind == "name":
            continue
        if kind == "member":
            if isinstance(found, ast.ClassDef) and name not in _members(fpath, found):
                out.append(key)
            continue
        # a keyword of a function, a method or a class
        if "." in owner:
            if not isinstance(found, ast.ClassDef):
                continue
            fn = _method(fpath, found, owner.split(".")[1])
            if fn is None:
                continue  # the member itself is reported missing (or an attribute)
            have = _params(fn)
        elif isinstance(found, ast.ClassDef):
            have = _init_params(fpath, found)
        elif isinstance(found, (ast.FunctionDef, ast.AsyncFunctionDef)):
            have = _params(found)
        else:
            continue
        if name not in have:
            out.append(key)
    return out


def _left_out(key: str) -> bool:
    """In ``LEFT_OUT`` itself, by its keyword's wildcard, or as a member or
    keyword of an entry."""
    m = re.search(r"\((\w+)\)$", key)
    if m and f"*({m.group(1)})" in LEFT_OUT:
        return True
    rel, _, path = key.partition("::")
    parts = path.split("(")[0].split(".")
    owners = [f"{rel}::{'.'.join(parts[:i])}" for i in range(1, len(parts) + 1)]
    return key in LEFT_OUT or any(o in LEFT_OUT for o in owners)


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_public_api_has_a_counterpart(rel):
    missing = [k for k in _missing(rel) if not _left_out(k)]
    assert not missing, f"no counterpart in speechflow_torch/{rel}: {missing}"


def test_left_out_is_current():
    """Every entry still names something the port lacks, with a reason."""
    missing = {k for rel in MODULES for k in _missing(rel)}
    stale = []
    for key, reason in LEFT_OUT.items():
        assert len(reason) > 20, key
        if key.startswith("*"):
            kw = key[1:]
            if not any(k.endswith(kw) for k in missing):
                stale.append(key)
        elif key not in missing:
            stale.append(key)
    assert not stale, f"the port now has these; take them out of LEFT_OUT: {stale}"


def test_the_walk_sees_the_api():
    """The walk finds the JAX package's public items (a broken walk would pass
    every module vacuously) and reports a name the port does not bind."""
    n = sum(len(_jax_items(rel)) for rel in MODULES)
    assert len(MODULES) > 150 and n > 2500
    assert "io/config.py::Config.section" in {k for _, k, _ in _jax_items("io/config.py")}
    assert _missing("utils/native.py") == [k for _, k, _ in _jax_items("utils/native.py")]
