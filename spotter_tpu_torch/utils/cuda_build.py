"""Build a hand-written CUDA source into a shared library and load it.

Route: `nvcc` by hand into a `.so` with a plain C interface, loaded with
ctypes (no PyTorch headers, so a build takes seconds, not minutes). The
library goes under `build/kernels/` at the repository root, in a directory
keyed by a hash of the sources and flags, at first use. Nothing here runs
at import.

Targets `sm_90a` (Hopper). A failed build raises with nvcc's output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclass
class KernelLibrary:
    """A loaded kernel library plus what its build reported."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build in BUILD_ROOT was reused
    log: str  # nvcc's output, `-Xptxas=-v` register/spill lines included


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def load_kernel_library(name: str, sources: tuple[str, ...]) -> KernelLibrary:
    """Build (once per source hash) and load `lib<name>.so` from `csrc/` sources.

    Callers cache the result (one load per process); a library already in
    BUILD_ROOT for the same sources and flags is loaded without a build.
    """
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}"
    so_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "nvcc.log"
    build_seconds = 0.0
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build beside the target, then rename: a concurrent build or a
        # killed build never leaves a half-written library at so_path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n{' '.join(cmd)}\n{log}"
            )
        log_path.write_text(log)
        os.replace(tmp, so_path)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(ctypes.CDLL(str(so_path)), so_path, build_seconds, log)
