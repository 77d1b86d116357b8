"""Dump a resolved configuration (reference: common/print_configuration_main.cc).

Port of cartographer_tpu/tools/print_configuration.py.

Usage:
    python -m cartographer_tpu_torch.tools.print_configuration \
        --configuration_directory DIR --configuration_basename FILE.lua
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--configuration_directory", action="append", default=[])
    parser.add_argument("--configuration_basename", required=True)
    parser.add_argument("--subdictionary", default=None)
    args = parser.parse_args(argv)

    from cartographer_tpu_torch.common.lua_config import _REFERENCE_DIRS, load_lua_file

    dirs = args.configuration_directory or []
    table = load_lua_file(args.configuration_basename, dirs + _REFERENCE_DIRS)
    if args.subdictionary:
        for part in args.subdictionary.strip(".").split("."):
            table = table[part]
    print(json.dumps(table, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
