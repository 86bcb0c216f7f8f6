"""Sanitizer harness of the port: the counterpart of
``tests/test_sanitize.py``'s checkify runs.

The reference threads ``jax.experimental.checkify``'s index, float and
division checks through its jitted kernels.  Here the port's plain
PyTorch versions run under a :class:`torch.overrides.TorchFunctionMode`
that checks the same three things on every torch call, on the CPU:

* every index tensor given to a gather, scatter, ``index_select``,
  ``take_along_dim``, ``index_put_`` or advanced indexing lies in
  ``[0, size)`` of the dimension it indexes (torch would silently wrap a
  negative advanced index);
* no floating-point result holds a NaN or an infinity;
* no integer division or remainder divides by zero.

Integer wrap-around is not checked: the hash mixing wraps on purpose,
and checkify does not check it either.  The cases are the reference's:
``lz77.lz77_analyze`` at levels 1, 6 and 9 on its 4,608-byte payload,
the decode's plain version on that payload's level-6 member, and the
decode-table build from the fixed code lengths.  A last test shows that
each check fires.
"""

import collections

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from decompress_tpu_torch import de
from decompress_tpu_torch.core import tables
from decompress_tpu_torch.ops import inflate, inflate_cu, lz77
from torch_threads import one_torch_thread  # noqa: F401

SEG = 4608

#: calls taking (tensor, dim, index, ...): the index must lie in tensor's dim
_DIM_INDEX = {"gather", "index_select", "scatter", "scatter_", "scatter_add",
              "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add",
              "index_add_", "index_copy", "index_copy_", "index_fill", "index_fill_"}
_DIVISIONS = {"div", "div_", "floor_divide", "floor_divide_", "remainder", "remainder_",
              "fmod", "fmod_", "__floordiv__", "__ifloordiv__", "__mod__", "__imod__",
              "__truediv__", "__itruediv__"}
_REVERSED = {"__rfloordiv__", "__rmod__", "__rtruediv__"}


class SanitizerError(AssertionError):
    pass


def _is_index(t) -> bool:
    return isinstance(t, torch.Tensor) and not t.dtype.is_floating_point \
        and t.dtype != torch.bool


class Sanitizer(TorchFunctionMode):
    """Checks every torch call made inside it; ``checked`` counts what
    was checked by kind."""

    def __init__(self):
        super().__init__()
        self.checked = collections.Counter()

    def _in_range(self, name, index, size):
        self.checked["index"] += 1
        if index.numel() and (int(index.min()) < 0 or int(index.max()) >= size):
            raise SanitizerError(
                f"{name}: index in [{int(index.min())}, {int(index.max())}] outside "
                f"[0, {size})")

    def _indexing(self, name, target, idx):
        """Advanced indexing: each integer index tensor against the size
        of the dimension it stands for."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        takes = [0 if e is None else
                 e.ndim if isinstance(e, torch.Tensor) and e.dtype == torch.bool else
                 0 if e is Ellipsis else 1 for e in idx]
        dim = 0
        for e, n in zip(idx, takes):
            if e is Ellipsis:
                dim += target.ndim - sum(takes)
            elif _is_index(e):
                self._in_range(name, e, target.shape[dim])
            dim += n

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _DIM_INDEX:
            dim = kwargs["dim"] if "dim" in kwargs else args[1]
            index = kwargs["index"] if "index" in kwargs else args[2]
            self._in_range(name, index, args[0].shape[dim])
        elif name == "take_along_dim":
            dim = kwargs.get("dim", args[2] if len(args) > 2 else None)
            self._in_range(name, args[1], args[0].shape[dim] if dim is not None
                           else args[0].numel())
        elif name in ("__getitem__", "__setitem__"):
            self._indexing(name, args[0], args[1])
        elif name in ("index_put", "index_put_"):
            for d, e in enumerate(args[1]):
                if _is_index(e):
                    self._in_range(name, e, args[0].shape[d])
        elif name in _DIVISIONS | _REVERSED:
            num, den = (args[1], args[0]) if name in _REVERSED else (args[0], args[1])
            ints = all(not (isinstance(x, torch.Tensor) and x.dtype.is_floating_point)
                       and not isinstance(x, float) for x in (num, den))
            if ints:
                self.checked["division"] += 1
                if (den == 0).any() if isinstance(den, torch.Tensor) else den == 0:
                    raise SanitizerError(f"{name}: integer division by zero")
        out = func(*args, **kwargs)
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype.is_floating_point:
                self.checked["float"] += 1
                if not bool(torch.isfinite(t).all()):
                    raise SanitizerError(f"{name}: NaN or infinity in a float result")
        return out


def _payload() -> bytes:
    rng = np.random.default_rng(5)
    return (b"sanitizer corpus text " * 120
            + rng.integers(0, 256, 800, np.uint8).tobytes())[:SEG]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_lz77_analyze_sanitized(level):
    data = _payload()
    seg = np.zeros((1, lz77.HIST + SEG), np.uint8)
    seg[0, lz77.HIST: lz77.HIST + len(data)] = np.frombuffer(data, np.uint8)
    args = (torch.from_numpy(seg), torch.tensor([len(data)], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32))
    with Sanitizer() as s:
        res = lz77.lz77_analyze(*args, level=level, seg_len=SEG)
    assert int(res["on_path"].sum()) > 0
    assert s.checked["index"] > 0 and s.checked["float"] > 0


def test_decode_plain_sanitized():
    body = np.frombuffer(de.deflate(_payload(), level=6, device="cpu"), np.uint8)
    kind, ll, dl, start = inflate.prepare_member(body)
    assert kind == "huff"
    st = inflate_cu.stage([body], [ll], [dl], [[(start, 0)]], "cpu")
    with Sanitizer() as s:
        cmds, ok, _ = inflate_cu.decode_plain(st["words"], st["tabs"], st["row_ptr"],
                                              st["start"], st["stop"], st["nbits"],
                                              st["blocks"], 8192)
    assert bool(ok[0]) and bool(st["tab_ok"][0])
    assert s.checked["index"] > 0


def test_build_row_tables_sanitized():
    ll = np.zeros((1, 288), np.int32)
    ll[0, : len(tables.FIXED_LIT_LENGTHS)] = tables.FIXED_LIT_LENGTHS
    dl = np.zeros((1, 32), np.int32)
    dl[0, : len(tables.FIXED_DIST_LENGTHS)] = tables.FIXED_DIST_LENGTHS
    with Sanitizer() as s:
        lr, ls, dr, ds, ok = inflate_cu.build_row_tables(torch.from_numpy(ll),
                                                         torch.from_numpy(dl))
    assert bool(ok[0]) and lr.shape == (1, inflate_cu.ROOT_SIZE)
    assert s.checked["index"] > 0


@pytest.mark.parametrize("fault", ["negative-index", "gather-past-end", "scatter-past-end",
                                   "nan", "integer-division-by-zero"])
def test_sanitizer_catches(fault):
    x = torch.arange(8)
    with pytest.raises(SanitizerError), Sanitizer():
        if fault == "negative-index":
            x[torch.tensor([-1])]
        elif fault == "gather-past-end":
            torch.gather(x[None], 1, torch.tensor([[8]]))
        elif fault == "scatter-past-end":
            torch.zeros(1, 8, dtype=torch.int64).scatter_add_(1, torch.tensor([[9]]),
                                                              x[None, :1])
        elif fault == "nan":
            torch.zeros(2) / torch.zeros(2)
        else:
            x // torch.zeros(8, dtype=torch.int64)
