"""LZMA compress / decompress CLI (the counterpart of
``examples/lzma_cli.py`` and the reference's ``examples/lzma/main.go``:
flags -c/-d/-k/-l, the classic .lzma container).

    python -m steroscopic_hardware_tpu_torch.examples.lzma_cli -c FILE
    python -m steroscopic_hardware_tpu_torch.examples.lzma_cli -d FILE.lzma
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    from steroscopic_hardware_tpu_torch.io import lzma_codec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("-c", "--compress", action="store_true")
    g.add_argument("-d", "--decompress", action="store_true")
    ap.add_argument("-k", "--keep", action="store_true",
                    help="keep the input file")
    ap.add_argument("-l", "--level", type=int, default=5,
                    help="compression level 1-9")
    ap.add_argument("file")
    args = ap.parse_args(argv)

    with open(args.file, "rb") as f:
        data = f.read()

    if args.compress:
        out_path = args.file + ".lzma"
        out = lzma_codec.compress_known_size(data, args.level)
    else:
        out_path = (args.file[:-5] if args.file.endswith(".lzma")
                    else args.file + ".out")
        out = lzma_codec.decompress(data)

    with open(out_path, "wb") as f:
        f.write(out)
    if not args.keep:
        os.remove(args.file)
    print(f"{args.file} -> {out_path} "
          f"({len(data)} -> {len(out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
