"""The schedule's batches: batches staged for the card in the window
(the program's ``de.BATCH_COUNTS["batches"]``), per MB of input
compressed."""

from benchmark import batch_counts

UNIT = "1/MB"
batch_counts.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    d = batch_counts.delta()
    if not d or not d.get("batches"):
        return None
    return d["batches"] / (ctx["counted"] / 1e6)
