"""Where the CUDA kernel libraries are built and found — the port's
counterpart of the reference's persistent JAX compilation cache
(``repro.launch.compile_cache``).

The reference turns its XLA compiles after a first deploy into disk
reads by pointing JAX's persistent cache at a directory that survives
restarts.  The port's compiles are the ``nvcc`` builds of its kernel
libraries, which ``kernels.build`` keys by a hash of each source, its
headers and the flags, and keeps in one directory: a library found
there is opened as built.  ``--compile-cache DIR`` moves that
directory; the default stays ``build/torch_kernels`` at the root of the
checkout, which git ignores.  ``telemetry.compile_watch`` counts the
builds and the libraries opened as built.
"""
from __future__ import annotations

import os
from pathlib import Path

from repro_torch.kernels import build

DEFAULT_DIR = build.BUILD_DIR


def resolve_cache_dir(cache_dir: str | None = None) -> Path:
    """``cache_dir`` (``~`` expanded), or the default directory when it
    is None or empty."""
    return Path(os.path.expanduser(cache_dir)) if cache_dir else DEFAULT_DIR


def enable_compilation_cache(cache_dir: str | None = None) -> Path:
    """Build and find the kernel libraries in ``cache_dir`` (resolved
    as above; created if missing) from now on; returns the directory.
    A library this process already opened stays open."""
    path = resolve_cache_dir(cache_dir)
    path.mkdir(parents=True, exist_ok=True)
    build.BUILD_DIR = path
    return path
