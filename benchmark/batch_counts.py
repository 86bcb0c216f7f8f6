"""What the traced run reads of the program's batch counter,
``decompress_tpu_torch.de.BATCH_COUNTS``: what each batch staged for the
card holds (``batches``, ``rows`` with padding, ``valid_rows``,
``payload_bytes``, ``row_bytes``).

A metric file that reads it calls :func:`arm` when it loads; only the
load from inside ``harness.measure``, after set-up and just before the
window opens, notes the counter (``program_spans.arm`` arms the same
way).  The first :func:`delta` after the window takes the counter's moves
since then, once.  A program without the counter (an older checkout)
gives None.
"""

from __future__ import annotations

from benchmark import program_spans

_state: dict = {"before": None, "delta": None}


def _counter() -> dict | None:
    """The program's batch counter, or None where it has none."""
    try:
        from decompress_tpu_torch import de
    except ImportError:
        return None
    return getattr(de, "BATCH_COUNTS", None)


def arm() -> None:
    """Note the counter where ``harness.measure`` loads the metric files;
    do nothing elsewhere."""
    if program_spans._in_measure():
        start()


def start() -> None:
    """Note the counter now, and drop the delta of an earlier window."""
    counts = _counter()
    _state.update(before=None if counts is None else dict(counts), delta=None)


def delta() -> dict | None:
    """The counter's moves since :func:`start`, taken at the first call
    after it; None where nothing was noted."""
    before = _state["before"]
    if before is not None:
        now = dict(_counter())
        _state.update(before=None, delta={k: now.get(k, 0) - before.get(k, 0)
                                          for k in set(now) | set(before)})
    return _state["delta"]
