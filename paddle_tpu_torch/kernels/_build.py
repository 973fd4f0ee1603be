"""Build and load the port's CUDA kernels.

Each source ``paddle_tpu_torch/csrc/<source>.cu`` compiles with ``nvcc``
into its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited kernel rebuilds
and an unchanged one is reused. Nothing is built at import: the first
launch builds what it needs, and :func:`build_all` builds every kernel
at once, one ``nvcc`` process per library, all started together. A
library is one source compiled with its own ``-D`` macros: a source may
hold several kernels, each with its own C entry point (``flash_bwd.cu``
holds both backward kernels, built as two libraries, one entry each, so
their modes compile in parallel), and a kernel may span several libraries
(the fused tick's six variants — three pool modes, dense or int8 weights
— are ``fused_decode_tick.cu`` compiled six times).

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

#: kernel name -> (its library, its C entry point, the entry's argument
#: types: pointers and the stream as void*, a float as float, element
#: strides as int64, everything else int)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the flash kernels' shape, Q-side and K-side strides, causal, dtype
_FLASH_DIMS = [_I] * 5 + [_L] * 6 + [_I] * 2
_FUSED_ARGS = [_P] * 44 + [_I] * 16 + [ctypes.c_float, _I, _P] + [_P]
#: the fused tick's libraries by (pool mode: 0 the model's type, 1 int8,
#: 2 fp8; int8 weights)
FUSED_VARIANTS = {(m, w8): "fused_decode_tick" + sfx + ("_w8" if w8 else "")
                  for m, sfx in enumerate(("", "_int8", "_fp8"))
                  for w8 in (False, True)}
SIGNATURES = {
    "paged_decode": ("paged_decode", "pt_paged_decode",
                     [_P] * 12 + [_I] * 11 + [_P]),
    "ragged_attention": ("ragged_attention", "pt_ragged_attention",
                         [_P] * 14 + [_I] * 12 + [_P]),
    "flash": ("flash", "pt_flash_fwd", [_P] * 5 + _FLASH_DIMS + [_P]),
    "flash_bwd_dkv": ("flash_bwd_dkv", "pt_flash_bwd_dkv",
                      [_P] * 10 + _FLASH_DIMS + [_P]),
    "flash_bwd_dq": ("flash_bwd_dq", "pt_flash_bwd_dq",
                     [_P] * 9 + _FLASH_DIMS + [_P]),
    "decode": ("decode", "pt_decode", [_P] * 9 + [_I] * 8 + [_P]),
    "rope_qk": ("rope_qk", "pt_rope_qk",
                [_P] * 6 + [_I] * 5 + [_L] * 6 + [_I] + [_P]),
    **{lib: (lib, "pt_" + lib, _FUSED_ARGS)
       for lib in FUSED_VARIANTS.values()},
}
#: library -> (its source under csrc/, its -D macros)
LIBRARIES = {
    **{src: (src, ()) for src in ("paged_decode", "ragged_attention",
                                  "flash", "decode", "rope_qk")},
    # the two backward kernels: one source, one entry a library
    **{f"flash_bwd_{k}": ("flash_bwd", (f"-DFLASH_BWD_ENTRY={i}",))
       for i, k in enumerate(("dkv", "dq"), 1)},
    **{lib: ("fused_decode_tick", (f"-DFT_MODE={m}", f"-DFT_W8={int(w8)}",
                                   f"-DFT_ENTRY=pt_{lib}"))
       for (m, w8), lib in FUSED_VARIANTS.items()},
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


def _library(name):
    """The library of kernel ``name`` (a library name maps to itself)."""
    return SIGNATURES[name][0] if name in SIGNATURES else name


def _sources(source):
    return [CSRC / f"{source}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name) -> Path:
    """The library ``name`` (a kernel or a library) is built into, named
    by a hash of its sources, macros and flags."""
    lib = _library(name)
    source, defines = LIBRARIES[lib]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for src in _sources(source):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{lib}-{h.hexdigest()[:16]}.so"


def _start(lib):
    """Start one nvcc for library ``lib`` unless it exists; returns
    ``(process, tmp_path, out_path, log_path)`` or None."""
    out = library_path(lib)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    source, defines = LIBRARIES[lib]
    cmd = [nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
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
    """Build every kernel (or those of ``names``, kernels or libraries),
    one nvcc per library in parallel. Returns ``{name: library path}``."""
    names = list(names or LIBRARIES)
    with _lock:
        jobs = {s: _start(s) for s in dict.fromkeys(map(_library, names))}
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
    """The compiler's output of the last build of ``name``'s library
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
