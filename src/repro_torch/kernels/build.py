"""Build and load the port's CUDA kernels.

At first use, each ``csrc/*.cu`` source is compiled by its own ``nvcc``
process (all started together) for ``sm_90a`` and the objects are linked into
one shared library with a plain C interface under
``build/repro_torch_kernels/`` at the root of the checkout.  The library's
name carries a hash of the sources and flags, so an edit rebuilds it and an
unchanged tree reuses it.  It is loaded with ``ctypes``; every entry point
returns ``cudaGetLastError()`` and the wrappers raise when it is not 0.
:func:`launch` is the lean way to call one: the rmsnorm forward and
backward, the SwiGLU backward, decode attention, the SSD scan's and the
mLSTM scan's tensor-core wrappers go through it, and so can any other.

No ``nvcc`` means no kernels: :func:`library` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rmsnorm.cu", "swiglu.cu", "decode_attention.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "rmsnorm_bwd.cu", "swiglu_bwd.cu", "mlstm_scan.cu",
           "mlstm_scan_bwd.cu", "ssd_scan.cu", "ssd_scan_bwd.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_longlong)

#: C entry point -> argument types (all return an int cudaError_t)
SIGNATURES = {
    "rt_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    "rt_rmsnorm_vec": (_P, _P, _P, _I, _I, _F, _I, _P),
    "rt_swiglu": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rt_swiglu_tc": (*(_P,) * 9, *(_I,) * 5, _P),
    "rt_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "rt_decode_attention_split": (*(_P,) * 6, *(_I,) * 8, _F, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _P, *(_I,) * 10, _F, _I, _P),
    "rt_flash_attention_tc": (_P, _P, _P, _P, _P, *(_I,) * 10, _F, _P),
    "rt_flash_attention_bwd": (*(_P,) * 10, *(_I,) * 10, _F, _I, _P),
    "rt_flash_attention_bwd_tc": (*(_P,) * 10, *(_I,) * 10, _F, _P),
    "rt_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "rt_rmsnorm_bwd_vec": (*(_P,) * 6, _I, _I, _I, _F, _I, _P),
    "rt_rmsnorm_bwd_vec_config": (_I, _I, _IP, _IP),
    "rt_swiglu_gate_bwd": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    "rt_swiglu_bwd_tc": (*(_P,) * 7, *(_I,) * 4, _P),
    "rt_mlstm_scan": (*(_P,) * 14, *(_I,) * 5, _F, _I, _P),
    "rt_mlstm_scan_bwd": (*(_P,) * 32, *(_I,) * 5, _F, _I, _P),
    "rt_mlstm_scan_tc": (*(_P,) * 12, _LP, *(_I,) * 5, _F, _P),
    "rt_mlstm_scan_bwd_tc": (*(_P,) * 26, _LP, *(_I,) * 5, _F, _P),
    "rt_ssd_scan": (*(_P,) * 8, *(_I,) * 7, _P),
    "rt_ssd_scan_bwd": (*(_P,) * 11, *(_I,) * 7, _P),
    "rt_ssd_scan_tc": (*(_P,) * 8, *(_I,) * 6, _P),
    "rt_ssd_scan_bwd_tc": (*(_P,) * 11, *(_I,) * 6, _P),
}


def nvcc_path() -> str:
    """The CUDA compiler on ``PATH`` or under ``$CUDA_HOME/bin``; raise if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels cannot be built"
    )


def source_digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their output, raise on a failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return logs


def build(build_dir: Path = BUILD_DIR) -> tuple[Path, float]:
    """Compile the library if this source digest has not been built yet.

    Returns the library's path and the seconds spent building (0 when reused).
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``<name>.log``.
    """
    lib = build_dir / f"librepro_torch_kernels_{source_digest()}.so"
    if lib.is_file():
        return lib, 0.0
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [build_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    logs = _run_all([
        [nvcc, *CFLAGS, "-c", str(CSRC / s), "-o", str(o)] for s, o in zip(SOURCES, objs)
    ])
    tmp = lib.with_suffix(f".{tag}.tmp")
    logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
    lib.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch(fn, name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on PyTorch's current stream
    of ``device`` and raise if it reports an error.

    The stream's raw handle comes from ``torch._C._cuda_getCurrentRawStream``,
    the call PyTorch's own compiler launches its kernels with: no device
    context is entered and no ``torch.cuda.Stream`` is built, which at the
    serving shape is as long as the kernel.  Only where ``device`` is not the
    current device does the launch enter it, so that the kernel runs there.
    """
    idx = device.index
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    check(err, name)


def checked_once(cache: dict, key, check_fn, *args):
    """``check_fn(*args)``'s result (not None), computed (and raising on what the
    kernel does not take) the first time ``key`` is seen and then read from
    ``cache``.  The key must fix everything ``check_fn`` looks at: shapes,
    dtypes and devices."""
    found = cache.get(key)
    if found is None:
        cache[key] = found = check_fn(*args)
    return found
