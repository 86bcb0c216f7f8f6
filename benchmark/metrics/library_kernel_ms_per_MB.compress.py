"""Device time of library kernels (torch's own, such as hash3's sort, the
scans and ``cummax`` inside the captured rounds A and B): every device
kernel of the traced window that is not one of the port's and not a copy,
in ms per MB of input compressed."""

from benchmark import readers

UNIT = "ms/MB"


def read(ctx: dict) -> float | None:
    if ctx["kind"] != "compress" or "device" not in ctx:
        return None
    s, n = readers.kernel_seconds(
        ctx, lambda name: not readers.is_copy(name)
        and not readers.named(name, readers.PORT_KERNELS))
    if n == 0:
        return None
    return 1e3 * s / (ctx["counted"] / 1e6)
