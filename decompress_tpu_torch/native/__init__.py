"""The host runtime: libtpuz (scalar checksums, the LZO codec and the
resumable streaming inflater) and libplan (the Huffman trees of one
batch: the block planner, :func:`plan_blocks`, and round B's bit-cost
tables, :func:`cost_tables`).

``tpuz.cpp`` is a byte-for-byte copy of the reference's
``decompress_tpu/native/tpuz.cpp`` (``tests/test_torch_native.py``
holds the two equal); this module is the port of its ``ctypes``
wrapper.  ``plan.cpp`` is the port's own: the native form of
``de.plan_blocks``, held byte for byte to the reference's planner by
``tests/test_torch_plan.py``, and of ``lz77._cost_tables_host``, held to
the reference's tables by ``tests/test_torch_cost.py``.  Each
source builds with ``g++`` at first use into
``build/native/<hash of source and flags>/lib<stem>.so`` beside the
package.  The build is atomic across processes: one process compiles
under an ``fcntl`` lock to a temporary name and renames it into place,
so no process loads a half-written file.  A failed build raises with
the compiler's output; there is no fallback.

Run ``python -m decompress_tpu_torch.native`` to build both libraries
and print their paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
SRC = _DIR / "tpuz.cpp"
PLAN_SRC = _DIR / "plan.cpp"
BUILD_DIR = _DIR.parent.parent / "build" / "native"
# portable code: the build directory may travel to another machine
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64, _u32, _i64, _i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int32
_vp = ctypes.c_void_p
#: the entry points of each source, by file name: (restype, argtypes)
_SIGS = {
    "tpuz.cpp": {
        "tpuz_adler32": (_u32, [_u8p, _u64, _u32]),
        "tpuz_crc32": (_u32, [_u8p, _u64, _u32]),
        "tpuz_crc32_combine": (_u32, [_u32, _u32, _u64]),
        "tpuz_adler32_combine": (_u32, [_u32, _u32, _u64]),
        "tpuz_lzo1x_decompress": (ctypes.c_int, [_u8p, _u64, _u8p, _u64,
                                                 ctypes.POINTER(_u64)]),
        "tpuz_lzo1x_compress": (ctypes.c_int, [_u8p, _u64, _u8p, _u64,
                                               ctypes.POINTER(_u64)]),
        "tpuz_inflate_new": (_vp, []),
        "tpuz_inflate_clone": (_vp, [_vp]),
        "tpuz_inflate_free": (None, [_vp]),
        "tpuz_inflate_reset": (None, [_vp]),
        "tpuz_inflate_error": (ctypes.c_char_p, [_vp]),
        "tpuz_inflate_total_out": (_u64, [_vp]),
        "tpuz_inflate_set_cursor": (None, [_vp, _u64]),
        "tpuz_inflate_cursor": (_u64, [_vp]),
        "tpuz_inflate_reset_keep_window": (None, [_vp]),
        "tpuz_inflate_set_window_bits": (None, [_vp, ctypes.c_int]),
        "tpuz_inflate_set_dictionary": (ctypes.c_int, [_vp, _u8p, _u32]),
        "tpuz_inflate_takeback": (ctypes.c_int, [_vp, _u8p, ctypes.c_int]),
        "tpuz_expand_cmds": (ctypes.c_int, [ctypes.POINTER(_u32), _u64, _u8p, _u64,
                                            ctypes.POINTER(_u64)]),
        "tpuz_inflate_run": (ctypes.c_int, [_vp, _u8p, _u64, ctypes.POINTER(_u64),
                                            _u8p, _u64, ctypes.POINTER(_u64)]),
    },
    "plan.cpp": {
        "tpuz_plan_blocks": (ctypes.c_int, [_i64, _vp, _vp, _vp, _vp, _i32, _i32,
                                            _vp, _vp, _vp, _vp, _i64, _i64,
                                            *[_vp] * 10]),
        "tpuz_cost_tables": (None, [_i64, _vp, _vp, _vp, _vp, _vp]),
    },
}


def lib_name(src: pathlib.Path) -> str:
    """The library built from ``src``: ``lib<stem>.so``."""
    return f"lib{src.stem}.so"


def _source_hash(src: pathlib.Path) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(src: pathlib.Path | None = None) -> pathlib.Path:
    """Compile the library of ``src`` (default :data:`SRC`) unless this
    exact build exists; its path."""
    src = SRC if src is None else src
    name = lib_name(src)
    out_dir = BUILD_DIR / _source_hash(src)
    lib_path = out_dir / name
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library builds with g++")
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():  # another process built it while we waited
            return lib_path
        tmp = out_dir / f"{name}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, str(src), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def _load(src: pathlib.Path | None = None) -> ctypes.CDLL:
    """The loaded library of ``src`` (default :data:`SRC`), built at
    first use."""
    src = SRC if src is None else src
    lib = _LIBS.get(src.name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(src.name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(src)))
        for name, (restype, argtypes) in _SIGS[src.name].items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBS[src.name] = lib
        return lib


def _u8(data) -> ctypes.Array:
    b = bytes(data)
    return (ctypes.c_uint8 * len(b)).from_buffer_copy(b) if b else (ctypes.c_uint8 * 1)()


def _ro_ptr(data):
    """Zero-copy (ptr, len, owner) view of ``data`` for read-only native
    calls.  ``owner`` must be kept referenced until the call returns.

    Handles contiguous numpy uint8 arrays and bytes without copying;
    anything else goes through one ``bytes()`` materialization.
    """
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8 or not data.flags["C_CONTIGUOUS"]:
            data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.size == 0:
            return (ctypes.c_uint8 * 1)(), 0, data
        ptr = ctypes.cast(data.ctypes.data, ctypes.POINTER(ctypes.c_uint8))
        return ptr, data.size, data
    b = data if isinstance(data, bytes) else bytes(data)
    if not b:
        return (ctypes.c_uint8 * 1)(), 0, b
    return (ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8)),
            len(b), b)


def adler32(data, value: int = 1) -> int:
    lib = _load()
    ptr, n, keep = _ro_ptr(data)
    res = lib.tpuz_adler32(ptr, n, value)
    del keep
    return res


def crc32(data, value: int = 0) -> int:
    lib = _load()
    ptr, n, keep = _ro_ptr(data)
    res = lib.tpuz_crc32(ptr, n, value)
    del keep
    return res


def crc32_combine(c1: int, c2: int, len2: int) -> int:
    return _load().tpuz_crc32_combine(c1, c2, len2)


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    return _load().tpuz_adler32_combine(a1, a2, len2)


class LzoNativeError(ValueError):
    pass


def _in_ptr(b: bytes):
    if not b:
        return (ctypes.c_uint8 * 1)()
    return ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8))


def lzo1x_compress(data) -> bytes:
    lib = _load()
    b = bytes(data)
    cap = len(b) + len(b) // 16 + 128
    out = ctypes.create_string_buffer(cap)
    n = ctypes.c_uint64()
    rc = lib.tpuz_lzo1x_compress(
        _in_ptr(b), len(b), ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(n))
    if rc != 0:
        raise LzoNativeError(f"lzo1x_compress failed: {rc}")
    return ctypes.string_at(out, n.value)


def lzo1x_decompress(data, out_cap: int) -> bytes:
    lib = _load()
    b = bytes(data)
    out = ctypes.create_string_buffer(max(out_cap, 1))
    n = ctypes.c_uint64()
    rc = lib.tpuz_lzo1x_decompress(
        _in_ptr(b), len(b), ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
        out_cap, ctypes.byref(n))
    if rc != 0:
        raise LzoNativeError(f"lzo1x_decompress failed: {rc}")
    return ctypes.string_at(out, n.value)


def _check_buffer(name: str, a: np.ndarray, dtype) -> None:
    if not isinstance(a, np.ndarray) or a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise TypeError(f"{name}: expected a C-contiguous numpy {np.dtype(dtype)} array")


def expand_cmds(cmds_u32: np.ndarray, out: np.ndarray) -> int:
    """Expand packed decoder commands (kind<<26|dist<<10|value) into a
    numpy uint8 buffer; returns produced byte count."""
    _check_buffer("cmds_u32", cmds_u32, np.uint32)
    _check_buffer("out", out, np.uint8)
    if not out.flags["WRITEABLE"]:
        raise ValueError("out: expected a writable array")
    lib = _load()
    n = ctypes.c_uint64()
    rc = lib.tpuz_expand_cmds(
        ctypes.cast(cmds_u32.ctypes.data, ctypes.POINTER(ctypes.c_uint32)),
        cmds_u32.size,
        ctypes.cast(out.ctypes.data, ctypes.POINTER(ctypes.c_uint8)),
        out.size, ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"expand_cmds failed: {rc}")
    return n.value


#: ``force_block`` of the planner -> its code in ``plan.cpp``; any other
#: value forces dynamic trees (stored blocks still win where cheaper)
_FORCE = {None: 0, "fixed": 1}


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


def plan_blocks(hist_lit, hist_dist, n_valid, final_flags, outs, *,
                force_block=None, shared_tree=False) -> tuple[np.ndarray, int]:
    """Plan the ``len(hist_lit)`` rows of a batch in one native call.

    ``outs`` are the planner's zeroed output arrays, written in place:
    (hdr_vals, hdr_bits, lit_codes, lit_bits, dist_codes, dist_bits,
    eob_vals, eob_bits), each C-contiguous with at least as many rows.
    ``shared_tree`` is False, True (one tree of the rows' summed counts)
    or a ``(lit_len, dist_len, header)`` tuple.  Returns the kind of each
    row (int8: 0 stored, 1 fixed, 2 dynamic) and the number of rows whose
    literal or distance tree was redistributed to fit 15 bits."""
    hl = np.ascontiguousarray(hist_lit, dtype=np.int64)
    hd = np.ascontiguousarray(hist_dist, dtype=np.int64)
    b = hl.shape[0]
    if hl.shape[1:] != (286,) or hd.shape != (b, 30):
        raise ValueError(f"histograms: expected [b, 286] and [b, 30], got "
                         f"{hl.shape} and {hd.shape}")
    nv = np.ascontiguousarray(np.asarray(n_valid)[:b], dtype=np.int64)
    fin = np.ascontiguousarray(np.asarray(final_flags)[:b] != 0, dtype=np.uint8)
    widths = (1024, 1024, 286, 286, 30, 30, 1, 1)
    dtypes = (np.uint32, np.int32) * 4
    for a, w, dt in zip(outs, widths, dtypes):
        _check_buffer("outs", a, dt)
        if a.ndim != 2 or a.shape[1] != w or a.shape[0] < b:
            raise ValueError(f"outs: expected [>= {b}, {w}], got {a.shape}")
    shared, tree, hdr_n, hdr_len = 0, (None,) * 4, 0, 0
    if isinstance(shared_tree, tuple):
        lit_len, dist_len, header = shared_tree
        keep = (np.ascontiguousarray(lit_len, dtype=np.int32),
                np.ascontiguousarray(dist_len, dtype=np.int32),
                np.ascontiguousarray(header.values, dtype=np.uint32),
                np.ascontiguousarray(header.nbits, dtype=np.int32))
        if keep[0].shape != (286,) or keep[1].shape != (30,):
            raise ValueError("shared_tree: expected 286 literal and 30 distance lengths")
        shared, tree = 2, tuple(map(_addr, keep))
        hdr_n, hdr_len = keep[2].size, int(header.bit_length)
    elif shared_tree:
        shared = 1
    kinds = np.zeros(b, np.int8)
    overflow = ctypes.c_int64(0)
    rc = _load(PLAN_SRC).tpuz_plan_blocks(
        b, _addr(hl), _addr(hd), _addr(nv), _addr(fin), _FORCE.get(force_block, 2),
        shared, *tree, hdr_n, hdr_len, *map(_addr, outs), _addr(kinds),
        ctypes.addressof(overflow))
    if rc != 0:
        raise ValueError("shared_tree: the header does not fit a row's 1024 slots")
    return kinds, overflow.value


def cost_tables(hist_lit, hist_dist) -> tuple[np.ndarray, np.ndarray, int]:
    """Round B's bit-cost tables of the ``len(hist_lit)`` rows of a batch
    in one native call: float32 ``lit_cost`` [b, 286] and ``dist_cost``
    [b, 30] (each symbol's 15-bit-limited code length, one EOB counted,
    13 where the row never used the symbol), and the number of rows whose
    literal or distance tree was redistributed to fit 15 bits."""
    hl = np.ascontiguousarray(hist_lit, dtype=np.int64)
    hd = np.ascontiguousarray(hist_dist, dtype=np.int64)
    b = hl.shape[0]
    if hl.shape[1:] != (286,) or hd.shape != (b, 30):
        raise ValueError(f"histograms: expected [b, 286] and [b, 30], got "
                         f"{hl.shape} and {hd.shape}")
    lit_cost = np.empty((b, 286), np.float32)
    dist_cost = np.empty((b, 30), np.float32)
    overflow = ctypes.c_int64(0)
    _load(PLAN_SRC).tpuz_cost_tables(b, _addr(hl), _addr(hd), _addr(lit_cost),
                                     _addr(dist_cost), ctypes.addressof(overflow))
    return lit_cost, dist_cost, overflow.value


class InflateStream:
    """Resumable raw-DEFLATE inflater (native streaming state machine)."""

    AWAIT, FLUSH, END, MALFORMED = 0, 1, 2, -3

    def __init__(self) -> None:
        self._lib = _load()
        self._h = self._lib.tpuz_inflate_new()
        if not self._h:
            raise MemoryError("tpuz_inflate_new failed")

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tpuz_inflate_free(self._h)
            self._h = None

    def reset(self) -> None:
        self._lib.tpuz_inflate_reset(self._h)

    def clone(self) -> "InflateStream":
        """Snapshot this decoder's full state: the copy resumes
        independently from the same stream position."""
        c = InflateStream.__new__(InflateStream)
        c._lib = self._lib
        c._h = self._lib.tpuz_inflate_clone(self._h)
        if not c._h:  # malloc failure returns NULL; never pass it on
            raise MemoryError("tpuz_inflate_clone failed")
        return c

    def unsafe_set_cursor(self, pos: int) -> None:
        """Position the 32 KiB window ring cursor directly (the
        window-restore primitive of a decode that resumes from a base)."""
        self._lib.tpuz_inflate_set_cursor(self._h, int(pos))

    @property
    def cursor(self) -> int:
        return self._lib.tpuz_inflate_cursor(self._h)

    def reset_keep_window(self) -> None:
        """Reset for a NEW raw stream, keeping window bytes + cursor:
        decode a base object, reset_keep_window, decode a delta whose
        far distances resolve into the base (no dictionary copy)."""
        self._lib.tpuz_inflate_reset_keep_window(self._h)

    def set_dictionary(self, dict_bytes: bytes) -> None:
        b = bytes(dict_bytes)
        self._lib.tpuz_inflate_set_dictionary(self._h, _u8(b), len(b))

    def set_window_bits(self, wbits: int) -> None:
        """Restrict back-references to a 2^wbits window (the decode side
        of the zlib CINFO negotiation)."""
        self._lib.tpuz_inflate_set_window_bits(self._h, int(wbits))

    @property
    def total_out(self) -> int:
        return self._lib.tpuz_inflate_total_out(self._h)

    def takeback(self) -> bytes:
        """Whole bytes buffered past the stream end that were consumed
        by earlier run() calls (call once after END)."""
        buf = (ctypes.c_uint8 * 8)()
        n = self._lib.tpuz_inflate_takeback(self._h, buf, 8)
        return bytes(buf[:n])

    @property
    def error(self) -> str:
        return self._lib.tpuz_inflate_error(self._h).decode()

    def run_into(self, src, out: np.ndarray, out_pos: int) -> tuple[int, int, int]:
        """Decode into a caller-owned numpy uint8 buffer starting at
        ``out_pos``; returns (status, consumed, produced).  ``src`` may
        be bytes or a contiguous numpy uint8 array, both passed
        zero-copy."""
        _check_buffer("out", out, np.uint8)
        if not out.flags["WRITEABLE"] or not 0 <= out_pos <= out.size:
            raise ValueError(f"out: expected a writable array and 0 <= out_pos <= "
                             f"{out.size}, got out_pos {out_pos}")
        sptr, slen, keep = _ro_ptr(src)
        dptr = ctypes.cast(out.ctypes.data + out_pos, ctypes.POINTER(ctypes.c_uint8))
        spos = ctypes.c_uint64(0)
        dpos = ctypes.c_uint64(0)
        status = self._lib.tpuz_inflate_run(
            self._h, sptr, slen, ctypes.byref(spos), dptr,
            out.size - out_pos, ctypes.byref(dpos))
        del keep
        return status, spos.value, dpos.value

    def run(self, src: bytes, dst_cap: int) -> tuple[int, int, bytes]:
        """Feed ``src``; returns (status, consumed, produced_bytes)."""
        src = bytes(src)
        sptr = _in_ptr(src)
        dbuf = getattr(self, "_dbuf", None)
        if dbuf is None or len(dbuf) < max(dst_cap, 1):
            dbuf = ctypes.create_string_buffer(max(dst_cap, 1))
            self._dbuf = dbuf
        dptr = ctypes.cast(dbuf, ctypes.POINTER(ctypes.c_uint8))
        spos = ctypes.c_uint64(0)
        dpos = ctypes.c_uint64(0)
        status = self._lib.tpuz_inflate_run(
            self._h, sptr, len(src), ctypes.byref(spos), dptr, dst_cap,
            ctypes.byref(dpos))
        return status, spos.value, ctypes.string_at(dbuf, dpos.value)
