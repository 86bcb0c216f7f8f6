#!/usr/bin/env python3
"""Round A's device kernels grouped by the source that launches them, for
one checkout of ``decompress_tpu_torch``, on one card.

    python3 scripts/torch_round_a_groups.py [ROOT] [LEVELS]

ROOT (default: the checkout holding this script) is the directory whose
``decompress_tpu_torch`` package is imported and built, so an unpacked
older commit can be profiled beside this one in one call.  LEVELS is a
comma-separated list (default ``6,4,12``).  For round A
(``lz77.lz77_analyze``) of ``chip_smoke.py``'s production batch (the 8
MiB corpus's first 8 segments of 130,560 bytes behind their history, T
= 163,328) at each level:

* one profiled eager run (``lz77_analyze.eager``) with the package's
  functions wrapped in profiler ranges (``record_function``) named after
  their groups: each device kernel (and copy or fill) is put in the
  group of the innermost range around the operator that launched it, or
  by its name where no operator launched it (the ``ctypes`` kernels of
  ``csrc/``).  The groups: the record
  build and key (words, fingerprints, probe fields, their stack, the
  sort key; since the ``fields`` kernel, that kernel), the sort, the
  runs, hash3 (its key, sort and probe), ``probe``/``extend``, and the
  parse tail (take/defer, the jump array and mark path, the exact
  verification, the histograms, the distance counts).  Kernels a group
  and their device ms (the sum of their durations);
* one profiled replay of the captured program: its device kernels and
  device ms, and the device ms by kernel name (the top 12).

Prints the card's name and power limit and one JSON line last.  Exits 2
without CUDA.
"""

from __future__ import annotations

import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent

#: (module, function) -> group: each is wrapped in a profiler range of
#: that label for the profiled run, where the checkout has it
_LABELS = {
    ("lz77", "_hash3_candidates"): "hash3",
    ("lz77", "_u32_words"): "record build and key",
    ("lz77", "_fingerprints"): "record build and key",
    ("lz77", "_probe_fields"): "record build and key",
    ("lz77", "_hash15"): "record build and key",
    ("lz77", "_sort_key"): "record build and key",
    ("probe_cu", "fields"): "record build and key",
    ("lz77", "_run_lengths"): "runs",
    ("probe_cu", "probe"): "probe/extend",
    ("probe_cu", "extend"): "probe/extend",
    ("lz77", "_match_candidates"): "candidates",
    ("lz77", "_take_defer"): "parse tail: take/defer",
    ("lz77", "_mark_batched"): "parse tail: jump, mark path",
    ("lz77", "_verify_matches"): "parse tail: verify",
    ("hist_cu", "histograms"): "parse tail: histograms",
    ("lz77", "_summarize_batch"): "parse tail: other",
    ("lz77", "_dist_counts_batch"): "parse tail: other",
}
_PREFIX = "round A group: "
#: device kernels no operator launches (csrc/), by name
_KERNELS = {"fields_kernel": "record build and key", "probe_kernel": "probe/extend",
            "extend_kernel": "probe/extend", "chunk_exit_kernel": "parse tail: jump, mark path",
            "chunk_hop_kernel": "parse tail: jump, mark path",
            "chunk_refine_kernel": "parse tail: jump, mark path",
            "hist_kernel": "parse tail: histograms"}


def labelled(torch, modules: dict):
    """Wrap each function of _LABELS that a module of ``modules`` has in a
    profiler range named after its group; returns the undo."""
    undo = []
    for (mod, name), group in _LABELS.items():
        fn = getattr(modules[mod], name, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _label=_PREFIX + group, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kw)

        setattr(modules[mod], name, wrapped)
        undo.append((modules[mod], name, fn))
    return lambda: [setattr(m, n, f) for m, n, f in undo]


def classify(names: list, kernel_name: str, state: dict) -> str:
    """The group of one device kernel, from the names of its launching
    operator and of the operators and ranges around it, innermost first
    (empty where no operator launched it).  ``state`` carries, across the
    kernels of one run in time order, whether ``_match_candidates`` has
    started its runs: the operators it calls itself are told apart by
    that."""
    labels = [n[len(_PREFIX):] for n in names if n.startswith(_PREFIX)]
    if "hash3" in labels:
        return "hash3"
    if "aten::sort" in names:
        return "sort"
    if labels and labels[0] == "candidates":
        if names[0] in ("aten::roll", "aten::eq"):
            state["runs"] = True
        return "runs" if state.get("runs") else "record build and key"
    if labels:
        return labels[0]
    for name, group in _KERNELS.items():
        if f"{name}(" in kernel_name or f"{name}<" in kernel_name:
            return group
    return "other"


def grouped(torch, prof) -> dict:
    """group -> {kernels, ms} over the device events of a profile: the
    kernels the profiler ties to an operator (its ``kernels``), taken in
    the operators' time order, then the rest by name."""
    events = list(prof.events())
    ops = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                  and e.kernels), key=lambda e: e.time_range.start)
    groups: dict = {}
    linked: dict = {}
    state: dict = {}

    def add(group, ms, kernel):
        g = groups.setdefault(group, {"kernels": 0, "ms": 0.0, "names": {}})
        g["kernels"] += 1
        g["ms"] += ms
        g["names"][kernel[:80]] = g["names"].get(kernel[:80], 0.0) + ms

    for op in ops:
        names, e = [], op
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        if _PREFIX + "candidates" not in names:
            state.pop("runs", None)
        for k in op.kernels:
            if k.name != op.name:  # not the operator's own (legacy) timing
                linked[k.name] = linked.get(k.name, 0) + 1
                add(classify(names, k.name, state), k.duration / 1e3, k.name)
    for e in events:  # the ranges' own spans on the device timeline are no kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith(_PREFIX):
            continue
        if linked.get(e.name, 0) > 0:
            linked[e.name] -= 1
            continue
        add(classify([], e.name, state), e.time_range.elapsed_us() / 1e3, e.name)
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"]))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_round_a_groups: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    levels = [int(v) for v in sys.argv[2].split(",")] if len(sys.argv) > 2 else [6, 4, 12]
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the corpus, the production batch and the card line
    sys.path.insert(0, str(root))
    from decompress_tpu_torch import _build, de
    from decompress_tpu_torch.ops import hist_cu, lz77, probe_cu

    card = chip_smoke.card_line()
    _build.build()
    dev = torch.device("cuda")
    arr = de._np_u8(chip_smoke.corpus_bytes())
    *batch, seg = chip_smoke.round_a_rows(arr, "production", dev)

    def profiled(fn):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler now and then records no kernel at all
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            if any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
                break
        return prof

    result = {"root": str(root), "card": card, "levels": {}}
    for level in levels:
        undo = labelled(torch, {"lz77": lz77, "probe_cu": probe_cu, "hist_cu": hist_cu})
        try:
            groups = grouped(torch, profiled(
                lambda: lz77.lz77_analyze.eager(*batch, level=level, seg_len=seg)))
        finally:
            undo()
        replay = chip_smoke.kernel_summary(torch, profiled(
            lambda: lz77.lz77_analyze(*batch, level=level, seg_len=seg)))
        top = list(replay.pop("by_name_ms").items())[:12]
        result["levels"][level] = {"eager_groups": groups, "replay": {
            **replay, "top_ms": {name[:90]: ms for name, ms in top}}}
        total = sum(g["kernels"] for g in groups.values())
        print(f"{root.name}: round A level {level}, eager: {total} device kernels, "
              f"{sum(g['ms'] for g in groups.values()):.3f} ms [{card}]", flush=True)
        for name, g in groups.items():
            lead = max(g["names"].items(), key=lambda kv: kv[1])
            print(f"  {name:28s} {g['kernels']:5d} kernels {g['ms']:8.3f} ms (most: "
                  f"{lead[1]:.3f} ms {lead[0][:60]})", flush=True)
        print(f"{root.name}: round A level {level}, one replay: {replay['device_kernels']} "
              f"device kernels, busy {replay['busy_ms']:.3f} ms over {replay['span_ms']:.3f} "
              f"ms ({100 * replay['busy_share']:.1f}% busy) [{card}]", flush=True)
        for name, ms in top:
            print(f"  {ms:8.3f} ms  {name[:100]}", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
