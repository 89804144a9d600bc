"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``csrc/`` for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads.  The sources are
compiled in parallel, one ``nvcc`` each, then linked.  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so a changed source is rebuilt on first use and an
unchanged one is loaded as it is.  Nothing here runs at import time: the
first kernel launch builds (or loads) the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # time of the last build (None: loaded)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda): the port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists.

    Raises ``RuntimeError`` carrying nvcc's output if a compile or the link
    fails.  ``ptxas``'s register and shared-memory report of a successful
    build is kept in ``build.log`` beside the library.
    """
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / "build.log").write_text("\n".join(logs))
        os.replace(tmp_lib, path)
    build_seconds = time.perf_counter() - t0
    return path


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rt_corr.argtypes = [i32, p, i32, p, p, i64, i64, i32, p]
    lib.rt_corr_argmax.argtypes = [i32, p, p, p, p, i64, i64, i32, i32, p,
                                   p, p, p]
    lib.rt_corr_batched.argtypes = [i32, p, p, p, i64, i64, i64, i32, i32,
                                    i32, i32, i32, i64, p]
    lib.rt_corr_argmax_batched.argtypes = [i32, p, p, p, p, i64, i64, i64,
                                           i32, i32, i32, i32, i32, i32, i32,
                                           i64, p, p, p, p]
    lib.rt_lastlayer_grad.argtypes = [i32, p, p, p, i32, p, p, i64, i64, i64,
                                      i32, i32, i32, i64, p]
    lib.rt_fl_gain_argmax.argtypes = [i32, p, p, p, i64, p, p, p, p, p]
    lib.rt_fl_gain_argmax_otf.argtypes = [i32, p, p, p, p, p, p, i64, i64, p,
                                          p, p, p, p]
    lib.rt_fl_gain_argmax_otf_tc.argtypes = [i32, p, p, p, p, p, p, i64, i64,
                                             i32, i32, p, p, p, p, p, p]
    lib.rt_sqrt_rn_mismatches.argtypes = [i32, p, p]
    lib.rt_sqdist.argtypes = [i32, p, p, i32, p, p, i64, i64, i64, p, p]
    lib.rt_sqdist_tc.argtypes = [i32, p, p, i32, p, p, i64, i64, i64, i32,
                                 i32, i32, p, p, p]
    lib.rt_bound_max.argtypes = [i32, p, i32, p, p, p, ctypes.c_float, p, p,
                                 i64, i64, i32, i32, i32, i32, i32, i64, p, p,
                                 p, p, p]
    lib.rt_hidden_grad.argtypes = [i32, p, i32, p, i32, p, i32, i64, i64, p,
                                   i64, i64, i64, i64, i32, p, p, p]
    lib.rt_hidden_grad_tc.argtypes = [i32, p, i32, p, i32, p, i32, p, i64,
                                      i64, i64, i64, i32, p, p, p]
    for fn in (lib.rt_corr, lib.rt_corr_argmax, lib.rt_corr_batched,
               lib.rt_corr_argmax_batched, lib.rt_lastlayer_grad,
               lib.rt_fl_gain_argmax, lib.rt_fl_gain_argmax_otf,
               lib.rt_fl_gain_argmax_otf_tc, lib.rt_sqrt_rn_mismatches,
               lib.rt_sqdist, lib.rt_sqdist_tc, lib.rt_bound_max,
               lib.rt_hidden_grad, lib.rt_hidden_grad_tc):
        fn.restype = i32
    lib.rt_error_string.argtypes = [i32]
    lib.rt_error_string.restype = ctypes.c_char_p


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        _declare(loaded)
        _lib = loaded
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib().rt_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel failed to launch: CUDA error "
                           f"{code} ({msg})")
