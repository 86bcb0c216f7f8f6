"""Build, load and call the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, ``libdecompress_tpu_torch_kernels.so``,
loaded with ``ctypes``.  The build runs at first use, into
``build/kernels/<hash of sources and flags>/`` beside the package, so an
edited source rebuilds and an unchanged one loads at once.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after its launches; the
wrappers pass it to :func:`launched`, which counts the launch in
:data:`LAUNCHES` under the wrapper's name and raises on a nonzero code.

Run ``python -m decompress_tpu_torch._build`` to build and print the
library's path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_NAME = "libdecompress_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points: name -> argument types (pointers, ints, the stream last)
_SIGNATURES = {
    "dtt_mark_path": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dtt_histograms": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P),
    "dtt_hist_cluster_blocks": (),
    "dtt_build_slots": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                        _I, _I, _P),
    "dtt_litbits_pref": (_P, _I, _P, _P, _P, _P, _I, _I, _P),
    "dtt_gain": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "dtt_inflate_rows": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                         _P, _P, _P, _P, _I, _P),
    "dtt_crc_chunks": (_P, _P, _P, _I, _P),
}

_lib: ctypes.CDLL | None = None

#: kernel launches by wrapper name; only :func:`launched` adds to it
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _failed(cmd: list[str], rc: int, out: str) -> RuntimeError:
    return RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> pathlib.Path:
    """Compile the kernels unless this exact build exists; its path.
    One ``nvcc`` per source, all started together, then one link."""
    out_dir = BUILD_DIR / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for cmd, _, proc in jobs:  # wait for every compile, failed or not
        out = proc.communicate()[0]
        if proc.returncode != 0:
            errors.append(_failed(cmd, proc.returncode, out))
    if errors:
        raise errors[0]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *(str(obj) for _, obj, _ in jobs)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise _failed(cmd, res.returncode, res.stdout + res.stderr)
    os.replace(tmp, lib_path)
    for _, obj, _ in jobs:
        obj.unlink()
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple | None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this type/shape."""
    _check_tensor(name, t, dtype, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_rows(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple) -> None:
    """Like :func:`check_cuda` for a 2-D tensor whose rows may be a
    strided view (each row contiguous, rows ``t.stride(0)`` apart)."""
    _check_tensor(name, t, dtype, shape)
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: rows must be contiguous and disjoint")


def launched(name: str, err: int) -> None:
    """Count one launch of wrapper ``name``; raise if it failed."""
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


if __name__ == "__main__":
    print(build())
