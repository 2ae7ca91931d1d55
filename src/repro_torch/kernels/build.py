"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, sizes
and a stream as integers) and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/torch_kernels/<name>-<hash>.so`` at the root
of the checkout, a directory git ignores.  The hash covers the source,
every ``csrc/*.cuh`` it includes and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is.  Every source builds
from the repository and the CUDA toolkit alone, and none includes
PyTorch's headers: ``nvcc`` then takes seconds per file, where a
``torch.utils.cpp_extension`` build takes minutes.

:func:`build_all` starts one ``nvcc`` per source, all at once, and
waits for them together, keeping each one's seconds in
``build_seconds`` and ``build_log``; :func:`load` builds (if needed) and
opens one library, noting in ``hit_log`` a library it found already
built.  ``telemetry.compile_watch`` reads the two logs.  Nothing here
runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("entropy", "flash_attention", "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+\.cuh)"', re.M)

_libs: dict[str, ctypes.CDLL] = {}
# seconds each library's nvcc took in this process (absent: loaded as built)
build_seconds: dict[str, float] = {}
# (wall time it started, seconds, library) of each nvcc this process ran
build_log: list[tuple[float, float, str]] = []
# (wall time, library) of each library opened as built, without nvcc
hit_log: list[tuple[float, str]] = []


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


def local_headers(name: str, csrc: Path = CSRC) -> list[Path]:
    """The ``csrc/*.cuh`` files ``csrc/<name>.cu`` includes, directly or
    through one another, in the order first met."""
    seen: list[Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        for inc in _LOCAL_INCLUDE.findall(todo.pop(0).read_text()):
            path = csrc / inc
            if path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_path(name: str, build_dir: Path | None = None,
                 csrc: Path = CSRC) -> Path:
    """Where ``name``'s library lives for the current source, its local
    headers and the flags (in ``build_dir``, default ``BUILD_DIR``)."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in local_headers(name, csrc):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _run(cmd: list[str]) -> tuple[int, str, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build_all(names=KERNELS, build_dir: Path | None = None
              ) -> dict[str, Path]:
    """Compile every kernel whose library is missing, all ``nvcc``s in
    parallel; raises with the compiler's output if one fails.  The
    compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<library>.log``, and each
    ``nvcc``'s seconds in ``build_seconds``.  ``build_dir`` defaults to
    ``BUILD_DIR`` (``launch.compile_cache`` may move it)."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, build_dir) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    tmps = {n: p.with_suffix(f".{os.getpid()}.tmp") for n, p in todo.items()}
    started = time.time()
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        runs = {n: pool.submit(_run, nvcc_command(nvcc, n, tmps[n]))
                for n in todo}
    failed = []
    for n, run in runs.items():
        rc, out, secs = run.result()
        build_seconds[n] = secs
        build_log.append((started, secs, n))
        Path(str(todo[n]) + ".log").write_text(out)
        if rc != 0:
            failed.append(f"{n}: nvcc exited {rc}\n{out}")
            tmps[n].unlink(missing_ok=True)
        else:
            os.replace(tmps[n], todo[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it first if
    needed), opened once per process."""
    lib = _libs.get(name)
    if lib is None:
        if name not in build_seconds and library_path(name).exists():
            hit_log.append((time.time(), name))
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _libs[name] = lib
    return lib
