"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points default to CUDA without falling back."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import cartographer_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = [k for k in sys.modules
       if k == "cartographer_tpu" or k.startswith("cartographer_tpu.")]
assert not bad, bad
# The per-scan path's, the fusion's, the TSDF's and the trimmers' modules,
# by name: a module missing here fails.
local_slam = ["mapping.imu_tracker", "mapping.motion_filter",
          "mapping.pose_extrapolator", "mapping.pose_extrapolator_interface",
          "mapping.local_trajectory_builder_2d", "mapping.submap_2d",
          "mapping.tsdf_2d", "mapping.normal_estimation_2d", "mapping.trimmers",
          "mapping.grid_2d", "mapping.scan_matching_2d", "mapping.map_builder",
          "mapping.pose_graph_2d", "mapping.constraint_builder_2d",
          "ops.tsdf_raycast_2d", "ops.raycast_2d", "ops.frontend_2d",
          "ops.scan_matching.gauss_newton_2d", "sensor.voxel_filter"]
# The 3D local-SLAM slice's modules.
local_slam += ["mapping.hybrid_grid", "mapping.paged_grid_3d",
               "mapping.scan_matching_3d", "mapping.submap_3d",
               "mapping.local_trajectory_builder_3d", "mapping.chunked_frontend_3d",
               "ops.raycast_3d", "ops.frontend_3d",
               "ops.scan_matching.rotational_histogram",
               "ops.scan_matching.gauss_newton_3d",
               "ops.scan_matching.correlative_3d"]
# The 3D backend slice's modules.
local_slam += ["ops.spa_solver_3d", "mapping.optimization_problem_3d",
               "ops.scan_matching.fast_correlative_3d", "native.bnb3",
               "mapping.constraint_builder_3d", "mapping.pose_graph_3d",
               "common.task"]
# The saved-maps slice's modules.
local_slam += ["native", "mapping.imu_based_pose_extrapolator",
               "sensor.compression", "transform.interpolation", "io.proto_stream",
               "io.proto.state_pb2", "io.serialization", "io.pbstream_compat",
               "io.submap_painter", "io.points_processor", "mapping.detect_floors"]
# The cloud-and-tools slice's modules.
local_slam += ["common.blocking_queue", "common.rate_timer", "common.math", "common.lua",
               "common.lua_config", "metrics", "metrics.prometheus", "cloud.wire",
               "cloud.map_builder_server", "cloud.map_builder_stub",
               "cloud.local_trajectory_uploader", "evaluation.relations_metric",
               "tools.map_builder_server_main", "tools.print_configuration",
               "tools.pbstream_main", "tools.autogenerate_ground_truth_main",
               "tools.compute_relations_metrics_main", "testing.server_config"]
# The multi-rank slice's modules.
local_slam += ["parallel", "parallel.partition", "parallel.sharded", "parallel.multihost",
               "testing.production_dryrun", "tools.multihost_worker"]
# The 2D main path's kernels.
local_slam += ["kernels.lm_match_2d", "kernels.supercover_2d", "testing.kernel_cases_2d"]
missing = [m for m in local_slam if pkg.__name__ + "." + m not in names]
assert not missing, missing
print(len(names))
"""


_IMPORT_WITHOUT_PROTOBUF = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["google.protobuf"] = None
import cartographer_tpu_torch as pkg
allowed = {"cartographer_tpu_torch.io.pbstream_compat",
           "cartographer_tpu_torch.io.proto.state_pb2"}
count = 0
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if info.name not in allowed:
        importlib.import_module(info.name)
        count += 1
print(count)
"""


_IMPORT_WITHOUT_GRPC = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["grpc"] = None
import cartographer_tpu_torch as pkg
count = 0
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not info.name.startswith("cartographer_tpu_torch.cloud."):
        importlib.import_module(info.name)
        count += 1
# The tool mains import the server only when they run it.
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.cloud import wire
print(count)
"""


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_imports_without_jax_or_the_jax_package():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module was imported


def test_only_the_protobuf_modules_import_protobuf():
    """io.pbstream_compat and io.proto.state_pb2 alone import
    google.protobuf; MapBuilder, the frontends and the npz serialization
    import without it."""
    proc = _run(_IMPORT_WITHOUT_PROTOBUF)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_only_the_cloud_modules_import_grpc():
    """Only cloud/'s server, stub and uploader import grpc: MapBuilder, the
    frontends, the wire codec and the tool mains import without it."""
    proc = _run(_IMPORT_WITHOUT_GRPC)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cartographer_tpu_torch.common.config import TrajectoryBuilder2DOptions
    from cartographer_tpu_torch.device import resolve_device
    from cartographer_tpu_torch.mapping.chunked_frontend_2d import (
        ChunkedLocalTrajectoryBuilder2D,
    )
    from cartographer_tpu_torch.ops import frontend_2d

    opts = TrajectoryBuilder2DOptions(use_imu_data=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChunkedLocalTrajectoryBuilder2D(opts, {"range"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontend_2d.init_state(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontend_2d.state_from_numpy({})
    from cartographer_tpu_torch.common.config import TrajectoryBuilder3DOptions
    from cartographer_tpu_torch.mapping.chunked_frontend_3d import (
        ChunkedLocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.mapping.local_trajectory_builder_3d import (
        LocalTrajectoryBuilder3D,
    )
    from cartographer_tpu_torch.ops import frontend_3d

    opts3 = TrajectoryBuilder3DOptions()
    for make in (
        lambda: ChunkedLocalTrajectoryBuilder3D(opts3, {"range"}),
        lambda: LocalTrajectoryBuilder3D(opts3, {"range"}),
        lambda: frontend_3d.state_from_numpy({}),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    ChunkedLocalTrajectoryBuilder2D(opts, {"range"}, device="cpu")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
