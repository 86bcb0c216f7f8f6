"""The schedule's batch occupancy: the payload bytes of the valid rows
over the bytes of every row staged for the card, padding rows included
(each row its segment width, history excluded), in the window (the
program's ``de.BATCH_COUNTS``), in %."""

from benchmark import batch_counts

UNIT = "%"
batch_counts.arm()


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress":
        return None
    d = batch_counts.delta()
    if not d or not d.get("row_bytes"):
        return None
    return 100.0 * d["payload_bytes"] / d["row_bytes"]
