"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use (never at import: importing the package must work on a
machine with no CUDA toolkit), one ``nvcc`` per source started together,
then one link. The library lands in ``pdm_tpu_torch/_build/`` under a name
keyed by the sources' and flags' hash, so an edited source never loads a
stale build.

The wrappers in ``ops/`` call :func:`load_kernels`, declare their entry's
``argtypes``, pass pointers and the current stream as ``c_void_p``, and
raise on a non-zero return (each entry returns ``cudaGetLastError()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the loaded library's path and, when this process built it, the
# compilers' diagnostic lines (ptxas registers and spills), for reports
build_info: Dict[str, object] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of pdm_tpu_torch "
        "build from source at first use"
    )


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join([nvcc, *ARCH_FLAGS, *NVCC_FLAGS]).encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, lib_path: Path) -> List[str]:
    """Compile every source in parallel, link one library; returns the
    compilers' diagnostic lines (ptxas register and spill reports)."""
    obj_dir = BUILD_DIR / f"obj-{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log: List[str] = []
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.extend(f"{src.name}: {line}" for line in out.splitlines() if line)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return log


def load_kernels() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_path = BUILD_DIR / f"libpdm_kernels-{_digest(nvcc)}.so"
            log: List[str] = []
            if not lib_path.exists():
                log = _compile(nvcc, lib_path)
            build_info.update(library=str(lib_path), log=log)
            _lib = ctypes.CDLL(str(lib_path))
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
