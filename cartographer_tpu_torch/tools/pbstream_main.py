"""pbstream CLI (reference: io/pbstream_main.cc:25 — `pbstream info|migrate`).

Port of cartographer_tpu/tools/pbstream_main.py.

Usage:
    python -m cartographer_tpu_torch.tools.pbstream_main info <file.pbstream>
    python -m cartographer_tpu_torch.tools.pbstream_main migrate <in> <out>
"""

from __future__ import annotations

import argparse
import json
import sys


def info(path: str) -> None:
    from cartographer_tpu_torch.io.serialization import pbstream_info

    with open(path, "rb") as f:
        state = f.read()
    print(json.dumps(pbstream_info(state), indent=2))


def migrate(in_path: str, out_path: str) -> None:
    """Version migration (io/serialization_format_migration.cc analog):
    reference-wire-format v1 streams gain 3D submap histograms and become
    v2; the internal tagged-npz payload is rewritten unchanged."""
    with open(in_path, "rb") as f_in:
        state = f_in.read()
    try:
        from cartographer_tpu_torch.io.pbstream_compat import migrate_pbstream

        migrated = migrate_pbstream(state)
    except Exception:
        # Internal tagged-npz payload: container rewrite only.
        from cartographer_tpu_torch.io.proto_stream import (
            ProtoStreamReader,
            ProtoStreamWriter,
        )
        import io as _io

        buf = _io.BytesIO()
        reader = ProtoStreamReader(_io.BytesIO(state))
        writer = ProtoStreamWriter(buf)
        for record in reader:
            writer.write(record)
        writer.close()
        migrated = buf.getvalue()
    with open(out_path, "wb") as f_out:
        f_out.write(migrated)
    print(f"migrated {in_path} -> {out_path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pbstream")
    sub = parser.add_subparsers(dest="command", required=True)
    p_info = sub.add_parser("info")
    p_info.add_argument("pbstream_file")
    p_migrate = sub.add_parser("migrate")
    p_migrate.add_argument("input")
    p_migrate.add_argument("output")
    args = parser.parse_args(argv)
    if args.command == "info":
        info(args.pbstream_file)
    elif args.command == "migrate":
        migrate(args.input, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
