"""Build and load the port's CUDA kernels.

Each source ``paddle_tpu_torch/csrc/<source>.cu`` compiles with ``nvcc``
into its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited kernel rebuilds
and an unchanged one is reused. Nothing is built at import: the first
launch builds what it needs, and :func:`build_all` builds every kernel
at once, one ``nvcc`` process per source, all started together. A source
may hold several kernels (``flash_bwd.cu`` holds both backward kernels),
each with its own C entry point.

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

#: kernel name -> (its source under csrc/, its C entry point, the entry's
#: argument types: pointers and the stream as void*, a float as float,
#: everything else int)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "paged_decode": ("paged_decode", "pt_paged_decode",
                     [_P] * 10 + [_I] * 10 + [_P]),
    "ragged_attention": ("ragged_attention", "pt_ragged_attention",
                         [_P] * 12 + [_I] * 11 + [_P]),
    "flash": ("flash", "pt_flash_fwd", [_P] * 5 + [_I] * 7 + [_P]),
    "flash_bwd_dkv": ("flash_bwd", "pt_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 7 + [_P]),
    "flash_bwd_dq": ("flash_bwd", "pt_flash_bwd_dq",
                     [_P] * 7 + [_I] * 7 + [_P]),
    "decode": ("decode", "pt_decode", [_P] * 9 + [_I] * 8 + [_P]),
    "fused_decode_tick": ("fused_decode_tick", "pt_fused_decode_tick",
                          [_P] * 34 + [_I] * 16 + [ctypes.c_float, _I, _P]
                          + [_P]),
}
#: the sources, one library each
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

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


def _source(name):
    """The source of kernel ``name`` (a source name maps to itself)."""
    return SIGNATURES[name][0] if name in SIGNATURES else name


def _sources(source):
    return [CSRC / f"{source}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name) -> Path:
    """The library built from ``name``'s source (a kernel or a source)."""
    source = _source(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(source):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{source}-{h.hexdigest()[:16]}.so"


def _start(source):
    """Start one nvcc for ``source`` unless its library exists; returns
    ``(process, tmp_path, out_path, log_path)`` or None."""
    out = library_path(source)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{source}.cu")]
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
    """Build every kernel (or those of ``names``, kernels or sources), one
    nvcc per source in parallel. Returns ``{name: library path}``."""
    names = list(names or SOURCES)
    with _lock:
        jobs = {s: _start(s) for s in dict.fromkeys(map(_source, names))}
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
    """The compiler's output of the last build of ``name``'s source
    (``-Xptxas -v`` lists each kernel's registers, shared memory and
    spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def libraries_loaded() -> int:
    """Kernel libraries loaded so far; a load may have built its library
    first (the serving gateway's watchdog exempts a step in which this
    grew: a build is not a hang)."""
    return len(_loaded)


def load(name):
    """The C entry point of kernel ``name``, building it first if needed."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    path = build_all([name])[name]
    with _lock:
        if name not in _loaded:
            _, symbol, argtypes = SIGNATURES[name]
            f = getattr(ctypes.CDLL(str(path)), symbol)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _loaded[name] = f
    return _loaded[name]


#: the CUDA error codes a bad launch most often returns
_CUDA_ERRORS = {1: "cudaErrorInvalidValue", 2: "cudaErrorMemoryAllocation",
                9: "cudaErrorInvalidConfiguration",
                82: "cudaErrorCooperativeLaunchTooLarge",
                98: "cudaErrorInvalidDeviceFunction",
                801: "cudaErrorNotSupported",
                209: "cudaErrorNoKernelImageForDevice",
                700: "cudaErrorIllegalAddress"}


def check(name, rc):
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{rc} ({_CUDA_ERRORS.get(rc, 'see cudaError_t')})")
