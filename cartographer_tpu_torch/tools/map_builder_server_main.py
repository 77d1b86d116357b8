"""Cloud SLAM server binary: flags -> Lua config -> serve loop.

Port of cartographer_tpu/tools/map_builder_server_main.py.

Reference: cloud/map_builder_server_main.cc:28-65 — resolve the Lua
configuration (MAP_BUILDER_SERVER table: embedded map_builder options,
server_address, uplink_server_address, upload_batch_size), optionally
expose Prometheus metrics, start the server, block until shutdown.

Usage:
    python -m cartographer_tpu_torch.tools.map_builder_server_main \
        --configuration_directory DIR \
        --configuration_basename map_builder_server.lua \
        [--server_address HOST:PORT] [--monitoring_port PORT] [--device cpu]

SIGINT/SIGTERM shut the server down cleanly. The MapBuilder runs on
`--device` (default cuda; without CUDA the server raises unless told
`--device cpu`).
"""

from __future__ import annotations

import argparse
import signal
import sys


def load_server_options(
    configuration_basename: str, configuration_directories
):
    """Resolve the MAP_BUILDER_SERVER Lua table into
    (map_builder_options, server_address, uplink_address_or_None,
    upload_batch_size). Equivalent of LoadMapBuilderServerOptions
    (cloud/map_builder_server_options.cc)."""
    from cartographer_tpu_torch.common import config as config_module
    from cartographer_tpu_torch.common import lua_config

    table = lua_config.load_lua_file(
        configuration_basename,
        list(configuration_directories) + lua_config._REFERENCE_DIRS,
    )
    server_table = table.get("MAP_BUILDER_SERVER")
    if server_table is None:
        raise lua_config.LuaConfigError(
            "configuration must return a MAP_BUILDER_SERVER table"
        )
    map_builder_options = lua_config._convert(
        config_module.MapBuilderOptions,
        server_table["map_builder"],
        strict=False,
        root="MAP_BUILDER_SERVER.map_builder",
    )
    uplink = server_table.get("uplink_server_address", "") or None
    return (
        map_builder_options,
        server_table.get("server_address", "0.0.0.0:50051"),
        uplink,
        int(server_table.get("upload_batch_size", 100)),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--configuration_directory",
        action="append",
        default=[],
        help="Directories in which configuration files are searched "
        "(the reference configuration directory is always appended).",
    )
    parser.add_argument(
        "--configuration_basename",
        required=True,
        help="Basename of the Lua configuration file "
        "(e.g. map_builder_server.lua).",
    )
    parser.add_argument(
        "--server_address",
        default=None,
        help="Override the Lua server_address.",
    )
    parser.add_argument(
        "--monitoring_port",
        type=int,
        default=None,
        help="Expose Prometheus metrics on this port "
        "(map_builder_server_main.cc exposer).",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device of the MapBuilder (cuda or cpu).",
    )
    parser.add_argument(
        "--shutdown_after_seconds",
        type=float,
        default=None,
        help="Exit after this many seconds (testing hook; default: serve "
        "until SIGINT/SIGTERM).",
    )
    args = parser.parse_args(argv)

    from cartographer_tpu_torch.cloud.map_builder_server import MapBuilderServer

    (
        map_builder_options,
        server_address,
        uplink_address,
        upload_batch_size,
    ) = load_server_options(
        args.configuration_basename, args.configuration_directory
    )
    if args.server_address is not None:
        server_address = args.server_address

    server = MapBuilderServer(
        map_builder_options,
        address=server_address,
        uplink_address=uplink_address,
        uplink_batch_size=upload_batch_size,
        monitoring_port=args.monitoring_port,
        device=args.device,
    )
    server.start()
    print(f"map_builder_server listening on port {server.port}", flush=True)
    if args.monitoring_port is not None:
        print(
            f"exposing metrics at http://localhost:{args.monitoring_port}"
            "/metrics",
            flush=True,
        )

    def _shutdown(signum, frame):
        server.shutdown()

    signal.signal(signal.SIGINT, _shutdown)
    signal.signal(signal.SIGTERM, _shutdown)
    server.wait_for_shutdown(args.shutdown_after_seconds)
    if args.shutdown_after_seconds is not None:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
