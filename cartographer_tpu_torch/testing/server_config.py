"""A MAP_BUILDER_SERVER configuration set as Lua files, for driving
tools/map_builder_server_main without the reference's configuration
directory.

The three files follow the reference's layout (configuration_files/
map_builder_server.lua includes map_builder.lua, which includes
pose_graph.lua) with the keys the typed options consume, at the typed
defaults of common/config.py; the server file switches the 2D builder on.
"""

from __future__ import annotations

import os

POSE_GRAPH_LUA = """\
POSE_GRAPH = {
  optimize_every_n_nodes = 90,
  constraint_builder = {
    sampling_ratio = 0.3,
    max_constraint_distance = 15.,
    min_score = 0.55,
    global_localization_min_score = 0.6,
    loop_closure_translation_weight = 1.1e4,
    loop_closure_rotation_weight = 1e5,
    log_matches = true,
    fast_correlative_scan_matcher = {
      linear_search_window = 7.,
      angular_search_window = math.rad(30.),
      branch_and_bound_depth = 7,
    },
  },
  matcher_translation_weight = 5e2,
  matcher_rotation_weight = 1.6e3,
  optimization_problem = {
    huber_scale = 1e1,
    acceleration_weight = 1.1e2,
    rotation_weight = 1.6e4,
    local_slam_pose_translation_weight = 1e5,
    local_slam_pose_rotation_weight = 1e5,
    odometry_translation_weight = 1e5,
    odometry_rotation_weight = 1e5,
    fixed_frame_pose_translation_weight = 1e1,
    fixed_frame_pose_rotation_weight = 1e2,
    log_solver_summary = false,
  },
  max_num_final_iterations = 200,
  global_sampling_ratio = 0.003,
  log_residual_histograms = true,
  global_constraint_search_after_n_seconds = 10.,
}
"""

MAP_BUILDER_LUA = """\
include "pose_graph.lua"

MAP_BUILDER = {
  use_trajectory_builder_2d = false,
  use_trajectory_builder_3d = false,
  num_background_threads = 4,
  pose_graph = POSE_GRAPH,
  collate_by_trajectory = false,
}
"""

MAP_BUILDER_SERVER_LUA = """\
include "map_builder.lua"

MAP_BUILDER_SERVER = {
  map_builder = MAP_BUILDER,
  num_event_threads = 4,
  num_grpc_threads = 4,
  server_address = "{server_address}",
  uplink_server_address = "",
  upload_batch_size = 100,
  enable_ssl_encryption = false,
  enable_google_auth = false,
}

MAP_BUILDER.collate_by_trajectory = true
MAP_BUILDER.use_trajectory_builder_2d = true
"""


def write_server_configuration(directory: str, server_address: str = "localhost:0") -> str:
    """Writes pose_graph.lua, map_builder.lua and map_builder_server.lua
    into `directory`; returns the server file's basename."""
    files = {
        "pose_graph.lua": POSE_GRAPH_LUA,
        "map_builder.lua": MAP_BUILDER_LUA,
        "map_builder_server.lua": MAP_BUILDER_SERVER_LUA.replace(
            "{server_address}", server_address
        ),
    }
    for name, text in files.items():
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)
    return "map_builder_server.lua"
