"""Build and load the Hopper kernels: ``csrc/*.cu`` -> one shared library.

The first call on a machine with a card compiles every source under
``src/repro_torch/csrc/`` with ``nvcc`` for ``sm_90a`` (one process per
source, all started together, then one link) into
``build/repro_torch/libflexvec_<hash>.so`` at the repository root, keyed
on a hash of the sources and flags, and loads it with ``ctypes``.  Later
calls reuse the loaded library; a later process reuses the file, and
processes that start together build it once (a file lock).  Nothing
here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the loaded library's ``path``, the ``seconds`` this process spent
#: building it (0.0 when the file already existed) and its build's
#: ``ptxas`` report (per-source -Xptxas -v text)
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> Dict[str, str]:
    """Compile each source to an object in parallel, then link ``target``.
    Returns each source's ptxas report; raises with nvcc's output on
    failure."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports, failed = {}, []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            reports[src.name] = out
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        partial = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-Xcompiler", "-fPIC", "-shared", "-o", str(partial),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(partial, target)  # atomic: a reader never sees a torn file
    return reports


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"libflexvec_{_digest()}.so"
        report = target.with_suffix(".ptxas.json")
        t0 = time.perf_counter()
        seconds = 0.0
        # one process builds, the others (shard workers started together)
        # wait for it; the OS drops the lock if its holder dies
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not target.exists():
                report.write_text(json.dumps(_compile(target)))
                seconds = time.perf_counter() - t0
        build_info.update(seconds=seconds, path=str(target),
                          ptxas=json.loads(report.read_text())
                          if report.exists() else {})
        lib = ctypes.CDLL(str(target))
        lib.flexvec_error_string.argtypes = [ctypes.c_int]
        lib.flexvec_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        msg = load().flexvec_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
