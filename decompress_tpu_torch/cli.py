"""``decompress``-compatible command line (counterpart of
``decompress_tpu/cli.py``).

Usage:  python -m decompress_tpu_torch.cli [-d] [-f deflate|zlib|gzip|lzo]
            [-l N] [--mtime T] [--filename NAME] [--device cuda|cpu]
            [INPUT] [OUTPUT]

``-d`` decompresses (default: compress), ``-f`` selects the format
(default zlib), ``-l`` the level (0-12, default 6).  With no positional
arguments it filters stdin to stdout.  Compression runs on ``--device``
(default ``cuda``; ``cpu`` takes the plain PyTorch path), decompression
on the host.  ``--device`` is checked in both directions: without a card
and without ``--device cpu`` it exits 1, as it does on malformed input,
with the message on stderr.  No environment variable selects the device.
"""

from __future__ import annotations

import argparse
import sys


def _read(path: str | None) -> bytes:
    if path is None or path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str | None, data: bytes) -> None:
    if path is None or path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="decompress",
        description="DEFLATE/zlib/gzip/LZO codec on an NVIDIA card "
        "(the PyTorch/CUDA port of decompress_tpu).",
    )
    ap.add_argument("-d", "--decompress", action="store_true",
                    help="decompress instead of compress")
    ap.add_argument("-f", "--format", default="zlib",
                    choices=["deflate", "zlib", "gzip", "lzo"],
                    help="stream format (default zlib)")
    ap.add_argument("-l", "--level", type=int, default=6,
                    help="compression level 0-12 (default 6; the "
                         "reference Ns table accepts 0-12)")
    ap.add_argument("--mtime", type=int, default=0, help="gzip MTIME field")
    ap.add_argument("--filename", default=None, help="gzip FNAME field")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where compression runs (default cuda)")
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("output", nargs="?", default=None)
    args = ap.parse_args(argv)

    if not 0 <= args.level <= 12:
        ap.error("level must be in 0..12")

    from . import de

    try:
        device = de._resolve_device(args.device)
    except RuntimeError as e:
        print(f"decompress: {e}", file=sys.stderr)
        return 1
    try:
        data = _read(args.input)
    except OSError as e:
        print(f"decompress: {e}", file=sys.stderr)
        return 1
    try:
        if args.decompress:
            if args.format == "deflate":
                out = de.inflate(data)
            elif args.format == "zlib":
                from . import zl

                out = zl.inflate(data)
            elif args.format == "gzip":
                from . import gz

                out = gz.decompress(data)
            else:
                from . import lzo

                out = lzo.uncompress(data)
        else:
            if args.format == "deflate":
                out = de.deflate(data, args.level, device=device)
            elif args.format == "zlib":
                from . import zl

                out = zl.deflate(data, args.level, device=device)
            elif args.format == "gzip":
                from . import gz

                name = args.filename
                if name is None and args.input not in (None, "-"):
                    name = args.input
                out = gz.compress(data, args.level, mtime=args.mtime,
                                  filename=name, device=device)
            else:
                from . import lzo

                out = lzo.compress(data, level=max(args.level, 1), device=device)
    except ValueError as e:
        print(f"decompress: {e}", file=sys.stderr)
        return 1
    _write(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
