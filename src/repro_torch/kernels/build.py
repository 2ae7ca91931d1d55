"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, sizes
and a stream as integers) and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/torch_kernels/<name>-<hash>.so`` at the root
of the checkout, a directory git ignores.  The hash covers the source
and the flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is.  No source includes PyTorch's headers: ``nvcc`` then
takes seconds per file, where a ``torch.utils.cpp_extension`` build
takes minutes.

:func:`build_all` starts one ``nvcc`` per source, all at once, and
waits for them together; :func:`load` builds (if needed) and opens one
library.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("entropy",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels are built on the machine with the card")


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Where ``name``'s library lives for the current source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=KERNELS, build_dir: Path = BUILD_DIR) -> dict[str, Path]:
    """Compile every kernel whose library is missing, all ``nvcc``s in
    parallel; raises with the compiler's output if one fails.  The
    compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<library>.log``."""
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, build_dir) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        Path(str(todo[n]) + ".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it first if
    needed), opened once per process."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _libs[name] = lib
    return lib
