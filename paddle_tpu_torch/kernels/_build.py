"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited kernel rebuilds
and an unchanged one is reused. Nothing is built at import: the first
launch builds what it needs, and :func:`build_all` builds every kernel
at once, one ``nvcc`` process per source, all started together.

Override the output directory with ``PADDLE_TPU_TORCH_BUILD_DIR`` and the
compiler with ``NVCC`` (else ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on
``PATH``, then the toolkit's default ``/usr/local/cuda/bin/nvcc``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
_REPO = _PKG.parent

#: kernel name -> its C entry point's argument types (pointers and the
#: stream as void*, everything else as int)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "paged_decode": ("pt_paged_decode", [_P] * 6 + [_I] * 8 + [_P]),
    "ragged_attention": ("pt_ragged_attention", [_P] * 8 + [_I] * 9 + [_P]),
    "flash": ("pt_flash_fwd", [_P] * 5 + [_I] * 7 + [_P]),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def build_dir() -> Path:
    return Path(os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR",
                               _REPO / "build" / "kernels"))


def nvcc() -> str:
    if os.environ.get("NVCC"):
        return os.environ["NVCC"]
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources(name):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name):
    """Start one nvcc for ``name`` unless its library exists; returns
    ``(process, tmp_path, out_path, log_path)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                cwd=str(CSRC))
    return proc, tmp, out, log


def _finish(name, job):
    proc, tmp, out, log = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode})"
                           f":\n{log.read_text()[-4000:]}")
    os.replace(tmp, out)


def build_all(names=None):
    """Build every kernel (or ``names``), one nvcc per source in parallel.
    Returns ``{name: library path}``."""
    names = list(names or SIGNATURES)
    with _lock:
        jobs = {n: _start(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    return {n: library_path(n) for n in names}


def build_log(name) -> str:
    """The compiler's output of the last build of ``name`` (``-Xptxas -v``
    lists each kernel's registers, shared memory and spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name):
    """The C entry point of kernel ``name``, building it first if needed."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    path = build_all([name])[name]
    with _lock:
        if name not in _loaded:
            symbol, argtypes = SIGNATURES[name]
            f = getattr(ctypes.CDLL(str(path)), symbol)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _loaded[name] = f
    return _loaded[name]


#: the CUDA error codes a bad launch most often returns
_CUDA_ERRORS = {1: "cudaErrorInvalidValue", 2: "cudaErrorMemoryAllocation",
                9: "cudaErrorInvalidConfiguration",
                98: "cudaErrorInvalidDeviceFunction",
                209: "cudaErrorNoKernelImageForDevice",
                700: "cudaErrorIllegalAddress"}


def check(name, rc):
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{rc} ({_CUDA_ERRORS.get(rc, 'see cudaError_t')})")
