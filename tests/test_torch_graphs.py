"""The port's captured programs (``ops/graphs``), on the CPU.

On a CUDA device each of the port's device stages (round A, round B,
the trims and the re-parse, the pack, the fixed step) runs as one replay
of a captured CUDA graph.  What a capture cannot hold must not be in a
program's function: a read of a device value on the host (``.item()``,
``bool()``, ``int()``, ``nonzero``, ``masked_select``, ``unique``,
boolean-mask indexing, ``.cpu()``, ``.numpy()``, ``.tolist()``) or a
tensor made from host data (``torch.tensor``, ``as_tensor``,
``from_numpy``).  Here each program's function runs on the CPU at small
sizes under :class:`HostSyncAudit`, a ``TorchFunctionMode`` and a
``TorchDispatchMode`` that fail on any of those:

* round A (``lz77_analyze``) at levels 1, 4, 6 and 12, with
  ``force_exact`` and with ``window_bits`` 9, behind a history;
* round B (``lz77_parse_cost``) with and without hot strides;
* the trims (``lz77_trim_candidates``) and the re-parse
  (``lz77_reparse_greedy``);
* the pack (``de.pack_device``) with no splits and with splits by
  commands and by bits;
* the fixed step (``pipeline.fixed_step``).

The audit fires on each kind of host read and on an upload from host
memory inside the region, as the fixed step made before its tables were
hoisted.  Round A (each case above and the B = 1 tail) builds its
words, records, keys and runs in one ``probe_cu.fields`` call, and no
operator of the torch record build (``roll``, ``stack``, the runs'
``flip``/``cummin``) runs outside it.  The key of a call changes with each static argument, shape,
dtype, device and ``None``-ness, and with nothing else.  On the CPU a
program is its function: its results equal the undecorated function's,
and nothing is captured.  The card half (replays equal to the eager
functions, clones, launch counts, a capture that fails, the LRU) is in
``tests/test_torch_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from decompress_tpu_torch import de
from decompress_tpu_torch.ops import graphs, lz77, pipeline, probe_cu
from torch_threads import one_torch_thread  # noqa: F401

CORPUS = pathlib.Path(__file__).parent / "corpus"
SEG = 4096
HIST = 2048

#: tensor methods and torch functions that read a value on the host or
#: make a tensor of host data
_HOST_CALLS = {"cpu", "numpy", "tolist", "item", "__bool__", "__int__", "__float__",
               "__index__", "pin_memory", "tensor", "as_tensor", "asarray", "from_numpy"}
#: aten operators that wait for the device (or make a tensor of host data)
_HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique",
             "_unique2", "unique_dim", "unique_consecutive", "is_nonzero", "equal",
             "lift_fresh", "lift_fresh_copy"}


class HostSyncError(AssertionError):
    pass


class _FunctionAudit(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _HOST_CALLS:
            raise HostSyncError(f"host read or host data in a program: {name}")
        if name == "to" and any(isinstance(a, (str, torch.device))
                                for a in (*args[1:], kwargs.get("device"))):
            raise HostSyncError("a copy between devices in a program: to(device)")
        return func(*args, **kwargs)


class _DispatchAudit(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _HOST_OPS or (name == "repeat_interleave"
                                 and kwargs.get("output_size") is None):
            raise HostSyncError(f"a host sync in a program: aten.{name}")
        if name in ("index", "index_put", "index_put_") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] or ())):
            raise HostSyncError(f"boolean-mask indexing in a program: aten.{name}")
        return func(*args, **kwargs)


class HostSyncAudit:
    """Both modes together: what runs inside may be captured."""

    def __enter__(self):
        self._modes = [_FunctionAudit(), _DispatchAudit()]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


def _rows(b=2, seg=SEG, hist=HIST, hist_len=HIST, seed=0):
    """b segments of book1 behind ``hist_len`` bytes of history, padded
    with a random tail in the last row."""
    raw = np.frombuffer((CORPUS / "book1").read_bytes(), np.uint8)
    data = np.zeros((b, hist + seg), np.uint8)
    for i in range(b):
        start = 50_000 + i * seg
        data[i, hist - hist_len:] = raw[start - hist_len:start + seg]
    rng = np.random.default_rng(seed)
    data[-1, hist + seg // 2:] = rng.integers(0, 256, seg - seg // 2, np.uint8)
    n_valid = np.array([seg] * (b - 1) + [seg - 301], np.int32)
    return (torch.from_numpy(data), torch.from_numpy(n_valid),
            torch.full((b,), hist_len, dtype=torch.int32))


def _round_a(level=6, **kw):
    return lz77.lz77_analyze(*_rows(), level=level, seg_len=SEG, hist=HIST, **kw)


def _round_b_args(hot: bool):
    data, nv, hl = _rows()
    res = _round_a()
    lc, dc = lz77._cost_tables_host(res["hist_lit"].numpy(), res["hist_dist"].numpy())
    hot_d = torch.tensor([[8, 16, 32, 64, 1, 0, 0, 0]] * 2, dtype=torch.int32) if hot else None
    return ((data, res["cand_length"], res["cand_dist"], nv, torch.from_numpy(lc),
             torch.from_numpy(dc), hl, hot_d),
            dict(seg_len=SEG, hist=HIST, lazy=True, window_bits=15))


def _pack_args(n_splits, split_bits):
    data, nv, _ = _rows(hist=0, hist_len=0)
    res = lz77.lz77_analyze(data, nv, torch.zeros_like(nv), level=4, seg_len=SEG, hist=0)
    (hv, hb), tabs, kinds = de.plan_blocks(res["hist_lit"].numpy(), res["hist_dist"].numpy(),
                                           nv.numpy(), np.array([False, True]))
    assert kinds == ["dynamic"] * 2
    lit_codes, lit_bits, dist_codes, dist_bits, eob_vals, eob_bits = tabs
    t = torch.from_numpy
    args = (res["on_path"], res["is_match"], res["length"], res["dist"], data,
            t((lit_codes.astype(np.int32) << 4) | lit_bits),
            t((dist_codes.astype(np.int32) << 4) | dist_bits), t(hv.astype(np.int64)), t(hb),
            t(eob_vals.astype(np.int64)), t(eob_bits))
    return args, dict(out_words=(9 * SEG) // 32 + 2 * de._HDR_PAD, n_splits=n_splits,
                      split_stride=256, split_bits=split_bits)


def _fixed_args():
    data, nv, _ = _rows(b=2, seg=1024, hist=lz77.HIST, hist_len=0)
    hl = torch.zeros_like(nv)
    bfinal = torch.tensor([0, 1], dtype=torch.int32)
    lit_cb, dist_cb = pipeline._fixed_tables(data.device)
    return ((data, nv, hl, bfinal, lit_cb, dist_cb),
            dict(level=6, seg_len=1024, out_words=(10 * 1024) // 32 + 64))


def _trim_args():
    data, nv, hl = _rows()
    res = _round_a()
    cl = res["cand_length"].clone()
    cl[:, ::7] = torch.where(cl[:, ::7] >= 3, cl[:, ::7] + 5, cl[:, ::7])  # overestimates
    bad = lz77.lz77_reparse_greedy(data, cl, res["cand_dist"], nv, seg_len=SEG, hist=HIST)
    assert not bool(bad["exact"].all())
    return ((data, bad["is_match"], bad["length"], bad["dist"], cl, res["cand_dist"], nv),
            dict(seg_len=SEG, hist=HIST))


def _reparse_args(two_round):
    data, nv, _ = _rows()
    res = _round_a()
    return ((data, res["cand_length"], res["cand_dist"], nv),
            dict(seg_len=SEG, hist=HIST, lazy=True, two_round=two_round))


#: (label, program, maker of its (args, kwargs)); made outside the audit
CASES = [
    *[(f"round A level {lv}", lz77.lz77_analyze,
       lambda lv=lv: (_rows(), dict(level=lv, seg_len=SEG, hist=HIST)))
      for lv in (1, 4, 6, 12)],
    ("round A force_exact", lz77.lz77_analyze,
     lambda: (_rows(), dict(level=6, seg_len=SEG, hist=HIST, force_exact=True))),
    ("round A window_bits 9", lz77.lz77_analyze,
     lambda: (_rows(), dict(level=6, seg_len=SEG, hist=HIST, window_bits=9))),
    ("round B", lz77.lz77_parse_cost, lambda: _round_b_args(False)),
    ("round B hot strides", lz77.lz77_parse_cost, lambda: _round_b_args(True)),
    ("trims", lz77.lz77_trim_candidates, _trim_args),
    ("re-parse", lz77.lz77_reparse_greedy, lambda: _reparse_args(False)),
    ("re-parse two_round", lz77.lz77_reparse_greedy, lambda: _reparse_args(True)),
    ("pack", de.pack_device, lambda: _pack_args(0, 0)),
    ("pack split by commands", de.pack_device, lambda: _pack_args(4, 0)),
    ("pack split by bits", de.pack_device, lambda: _pack_args(4, 4096)),
    ("fixed step", pipeline.fixed_step, _fixed_args),
]


def _leaves(out):
    leaves = []
    graphs._flatten(out, leaves, "result")
    return leaves


@pytest.mark.parametrize("label,prog,build", CASES, ids=[c[0] for c in CASES])
def test_program_has_no_host_sync(label, prog, build):
    args, kw = build()
    with HostSyncAudit():
        out = prog.eager(*args, **kw)
    assert _leaves(out)


@pytest.mark.parametrize("label,prog,build", CASES, ids=[c[0] for c in CASES])
def test_program_on_cpu_is_its_function(label, prog, build):
    args, kw = build()
    captures = sum(graphs.CAPTURES.values())
    got, want = prog(*args, **kw), prog.eager(*args, **kw)
    assert graphs._flatten(got, [], "") == graphs._flatten(want, [], "")
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert sum(graphs.CAPTURES.values()) == captures


class _OpLog(TorchDispatchMode):
    """The aten operators run, each with whether a fields call was open."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func.overloadpacket.__name__, self.inside > 0))
        return func(*args, **(kwargs or {}))


ROUND_A = [c for c in CASES if c[0].startswith("round A")] + [
    ("round A B = 1 tail", lz77.lz77_analyze,
     lambda: (_rows(b=1), dict(level=6, seg_len=SEG, hist=HIST)))]


@pytest.mark.parametrize("label,prog,build", ROUND_A, ids=[c[0] for c in ROUND_A])
def test_round_a_builds_its_record_in_one_fields_call(label, prog, build, monkeypatch):
    """The record build is one fields call (on the card one launch of its
    kernel in a replay): none of its torch operators runs outside it."""
    args, kw = build()
    log, calls = _OpLog(), []
    fields = probe_cu.fields

    def spy(*a, **k):
        calls.append(k)
        log.inside += 1
        try:
            return fields(*a, **k)
        finally:
            log.inside -= 1

    monkeypatch.setattr(probe_cu, "fields", spy)
    with log:
        prog.eager(*args, **kw)
    assert len(calls) == 1
    outside = {name for name, inside in log.ops if not inside}
    assert not outside & {"roll", "stack", "flip", "cummin"}, outside
    assert "roll" in {name for name, inside in log.ops if inside}  # the plain build here


def _old_fixed_upload(data):
    """The fixed step's tables as it made them inside its region before
    they were hoisted: a copy from host memory, which no capture holds."""
    lit_code, lit_len, _, _ = pipeline._fixed_code_arrays()
    lit_cb = torch.from_numpy((lit_code.astype(np.int64) << 4) | lit_len).to(data.device)
    return lit_cb[data[:, :4].to(torch.int64)]


@pytest.mark.parametrize("fault", ["upload", "item", "bool", "int", "nonzero", "mask",
                                   "masked_select", "unique", "cpu", "numpy", "tolist",
                                   "tensor"])
def test_audit_fires(fault):
    x = torch.arange(8)
    with pytest.raises(HostSyncError), HostSyncAudit():
        if fault == "upload":
            _old_fixed_upload(x[None].to(torch.uint8))
        elif fault == "item":
            x.sum().item()
        elif fault == "bool":
            bool((x > 3).any())
        elif fault == "int":
            int(x[0])
        elif fault == "nonzero":
            torch.nonzero(x)
        elif fault == "mask":
            x[x > 3]
        elif fault == "masked_select":
            torch.masked_select(x, x > 3)
        elif fault == "unique":
            torch.unique(x)
        elif fault == "cpu":
            x.cpu()
        elif fault == "numpy":
            x.numpy()
        elif fault == "tolist":
            x.tolist()
        else:
            torch.tensor([1, 2])


@graphs.program(static=("k", "flag"))
def _toy(x, y=None, *, k: int, flag: bool = False):
    out = x * k if y is None else x * k + y
    return {"out": out, "pair": (out, x)} if flag else out


def _key(*args, **kw):
    return _toy.key(*args, **kw)[0]


def test_key_changes_with_each_static_shape_dtype_device_and_none():
    x = torch.zeros(3, 4, dtype=torch.int32)
    base = _key(x, k=2)
    changed = [
        _key(x, k=3), _key(x, k=2, flag=True), _key(torch.zeros(3, 5, dtype=torch.int32), k=2),
        _key(torch.zeros(4, 3, dtype=torch.int32), k=2), _key(x.to(torch.int64), k=2),
        _key(torch.zeros(3, 4, dtype=torch.int32, device="meta"), k=2),
        _key(x, torch.zeros(3, 4, dtype=torch.int32), k=2)]
    assert len({base, *changed}) == len(changed) + 1


def test_key_ignores_values_strides_and_argument_spelling():
    x = torch.zeros(3, 4, dtype=torch.int32)
    base = _key(x, k=2)
    strided = torch.arange(40, dtype=torch.int32).reshape(5, 8)[1:4, ::2]
    transposed = torch.ones(4, 3, dtype=torch.int32).t()
    assert not strided.is_contiguous() and not transposed.is_contiguous()
    same = [_key(x + 7, k=2), _key(strided, k=2), _key(transposed, k=2),
            _key(x=x, k=2), _key(x, None, k=2), _key(x, k=2, flag=False)]
    assert all(s == base for s in same)


def test_round_b_with_and_without_hot_strides_are_two_programs():
    (args, kw), (args_hot, _) = _round_b_args(False), _round_b_args(True)
    assert lz77.lz77_parse_cost.key(*args, **kw)[0] != \
        lz77.lz77_parse_cost.key(*args_hot, **kw)[0]
    assert lz77.lz77_parse_cost.key(*args, **kw)[0] == \
        lz77.lz77_parse_cost.key(*(a.clone() if a is not None else None for a in args),
                                 **kw)[0]


def test_results_keep_their_structure():
    x = torch.arange(6).reshape(2, 3)
    out = _toy(x, k=2, flag=True)
    leaves = []
    spec = graphs._flatten(out, leaves, "result")
    again = graphs._unflatten(spec, iter(leaves))
    assert list(again) == ["out", "pair"] and isinstance(again["pair"], tuple)
    assert torch.equal(again["out"], x * 2) and again["pair"][1] is x


def test_program_arguments_are_checked():
    with pytest.raises(TypeError, match="declare the argument static"):
        _toy(torch.zeros(2), 3, k=1)
    with pytest.raises(ValueError, match="no arguments"):
        graphs.program(static=("nope",))(lambda x: x)
