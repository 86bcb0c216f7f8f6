"""Each kernel's byte count (``benchmark/rooflines``) is a frozen copy of
``chip_smoke.py``'s bound arithmetic: equal to it on the tensors the
kernel wrappers get in a compression on the CPU, and to PERF.md §6's
bounds at the main shapes."""

import collections

import pytest
import torch

from benchmark import spec
from benchmark.rooflines import _peaks

KERNELS = ("fields", "probe", "extend", "mark_path", "histograms", "litbits_pref", "gain",
           "build_slots", "crc_rows")
#: wrapper of each kernel: (module of decompress_tpu_torch.ops, function)
WRAPPERS = {"fields": ("probe_cu", "fields"), "probe": ("probe_cu", "probe"),
            "extend": ("probe_cu", "extend"), "mark_path": ("parse_cu", "mark_path"),
            "histograms": ("hist_cu", "histograms"), "litbits_pref": ("cost_cu", "litbits_pref"),
            "gain": ("cost_cu", "gain"), "build_slots": ("pack_cu", "build_slots"),
            "crc_rows": ("crc_cu", "crc32_rows")}
#: PERF.md §6's bound ms at B = 8, T = 163,328 (130,560 bytes of segment),
#: and 65 rows for CRC-32
SECTION_6_MS = {"fields": 0.0241, "probe": 0.0181, "extend": 0.0156, "mark_path": 0.0016,
                "histograms": 0.0034, "litbits_pref": 0.0028, "gain": 0.0075,
                "build_slots": 0.0084}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


@pytest.fixture(scope="module")
def recorded():
    """(args, kwargs, outputs) of every wrapper call of a level-6 one-shot
    and archive on the CPU (B = 4 rows, history 32 KiB and none)."""
    import importlib

    from decompress_tpu_torch import gz
    from decompress_tpu_torch.parallel import sharded

    from benchmark import inputs

    calls = collections.defaultdict(list)
    saved = []
    for name, (mod_name, fn_name) in WRAPPERS.items():
        mod = importlib.import_module(f"decompress_tpu_torch.ops.{mod_name}")
        fn = getattr(mod, fn_name)

        def rec(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            calls[_name].append((a, k, out))
            return out

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, rec)
    try:
        x = inputs.make_input(inputs.load_corpus("calgary"), 3 * 40_000 + 7, 9, 0)
        gz.compress(x, 6, segment_size=40_000, device="cpu")
        sharded.sharded_gzip_compress(x, 6, member_size=40_000, device="cpu")
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)
    return calls


def _smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("kernel", KERNELS)
def test_byte_count_equals_chip_smoke_bound(recorded, kernel):
    smoke = _smoke()
    roof = spec.load_module("rooflines", kernel)
    assert recorded[kernel], f"{kernel} was not called"
    for args, kw, out in recorded[kernel]:
        if kernel in ("fields", "probe", "extend"):
            moved = smoke.candidate_bound_bytes(kernel, args, kw, out)
        else:
            moved = sum(t.nbytes for t in _tensors(args) + _tensors(out))
        rows = args[0].shape[0]
        seg = 40_000
        t = args[0].shape[1] if kernel in ("fields", "probe", "extend") else seg
        if kernel == "gain" and len(_tensors(args)) > 5:  # the hot lane, left out
            moved -= sum(t_.nbytes for t_ in _tensors(args)[2:4])
        assert roof.bytes_per_launch(rows, t, seg) == moved


@pytest.mark.parametrize("kernel", sorted(SECTION_6_MS))
def test_bound_at_the_main_shapes(kernel):
    roof = spec.load_module("rooflines", kernel)
    ms = 1e3 * roof.bytes_per_launch(8, 163_328, 130_560) / _peaks.HBM_BYTES_PER_S
    assert round(ms, 4) == SECTION_6_MS[kernel]


def test_crc_bound_at_65_rows():
    roof = spec.load_module("rooflines", "crc_rows")
    ms = 1e3 * roof.bytes_per_launch(65, 130_560, 130_560) / _peaks.HBM_BYTES_PER_S
    assert round(ms, 4) == 0.0025


def test_peak_is_chip_smokes():
    assert _peaks.HBM_BYTES_PER_S == _smoke().HBM_BYTES_PER_S


def test_listed_kernel_with_no_launch_fails_the_run():
    reader = spec.load_module("metrics", "compress_kernels_roofline")
    ctx = {"kind": "compress", "level": 6, "kernels": ("gain", "build_slots"),
           "batches": [(8, 163_328, 130_560)],
           "device": {"by_name": {"void gain_kernel(int*)": [1e-3, 1]}}}
    with pytest.raises(RuntimeError, match="build_slots"):
        reader.read(ctx)
    ctx["device"]["by_name"]["slots_kernel"] = [1e-3, 1]
    assert 0 < reader.read(ctx) < 100
