"""Build and load the port's CUDA kernels.

Each source in ``speechflow_torch/csrc`` (``*.cu``) is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``. The build happens at first use, into
``speechflow_torch/_build`` (listed in ``.gitignore``); each library's file
name carries a hash of its source, so an edited kernel is rebuilt and a
stale library is never loaded. All sources are compiled in parallel, one
``nvcc`` process each.

Only ``ctypes`` and the standard library are imported here, so the CPU tests
can import every kernel module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import typing as tp
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "nvcc_command", "build_all", "load_library", "function",
           "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: tp.Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(name: str, out: Path) -> tp.List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def sources() -> tp.List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> tp.Dict[str, dict]:
    """Compile every kernel source that is not built yet, all in parallel.

    Returns, per source, the command, the seconds it took and the compiler's
    output (register and shared-memory use from ``-Xptxas -v``). Raises if a
    compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    report = {}
    for name in sources():
        out = _target(name)
        if out.exists():
            report[name] = {"cmd": None, "seconds": 0.0, "log": "cached"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(name, tmp)
        jobs[name] = (cmd, tmp, out, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, out, t0, proc) in jobs.items():
        log, _ = proc.communicate()
        report[name] = {"cmd": " ".join(cmd), "seconds": time.perf_counter() - t0,
                        "log": log}
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees a partial library
    if failed:
        logs = "\n".join(f"--- {n}\n{report[n]['log']}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources first if
    needed. The caller declares ``argtypes`` and ``restype``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes: tp.Sequence) -> tp.Any:
    """A C function of a kernel library with its ``argtypes`` declared
    (``ctypes.c_void_p`` for pointers and the stream) and an ``int``
    (``cudaError_t``) result."""
    fn = getattr(load_library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
