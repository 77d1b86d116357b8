"""The port's tool mains against the JAX package's: pbstream info and
migrate on the golden reference stream and on a port-written state, the
ground-truth relations and their metrics on one state, print_configuration
on written Lua files, and the server main as a subprocess on the CPU. The
mains that build a MapBuilder run on cuda unless told `--device cpu`, and
raise without CUDA."""

import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cartographer_tpu.io.proto_stream import ProtoStreamReader as JReader
from cartographer_tpu.tools import autogenerate_ground_truth_main as jground_truth
from cartographer_tpu.tools import compute_relations_metrics_main as jrelations
from cartographer_tpu.tools import pbstream_main as jpbstream
from cartographer_tpu.tools import print_configuration as jprint
from cartographer_tpu_torch.cloud.map_builder_stub import MapBuilderStub
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.evaluation import relations_metric
from cartographer_tpu_torch.io.proto_stream import ProtoStreamReader
from cartographer_tpu_torch.mapping.map_builder import MapBuilder
from cartographer_tpu_torch.testing.server_config import write_server_configuration
from cartographer_tpu_torch.testing.synthetic import generate_fake_range_measurements
from cartographer_tpu_torch.tools import autogenerate_ground_truth_main as ground_truth
from cartographer_tpu_torch.tools import compute_relations_metrics_main as relations
from cartographer_tpu_torch.tools import map_builder_server_main as server_main
from cartographer_tpu_torch.tools import pbstream_main
from cartographer_tpu_torch.tools import print_configuration
from tests.test_torch_serialization import map_builder_options, trajectory_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "reference_golden_mini.pbstream")
DIRECTION = np.array([2.0, 1.0, 0.0]) / np.sqrt(5.0)
# Relations on a 0.6 m run: a short covered distance, loose outlier gates.
GT_FLAGS = ["--min_covered_distance", "0.1", "--outlier_threshold_meters", "0.5",
            "--outlier_threshold_radians", "0.5"]


@pytest.fixture(scope="module")
def port_state(tmp_path_factory):
    """A port map on the CPU (the semicircle world, 0.6 m in 3 s), saved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mb = MapBuilder(map_builder_options(tconfig), device="cpu")
        tid = mb.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        builder = mb.get_trajectory_builder(tid)
        for m in generate_fake_range_measurements(
                translation=DIRECTION * 0.6, duration=3.0, time_step=0.05):
            builder.add_sensor_data("range", m)
        mb.finish_trajectory(tid)
        mb.pose_graph.run_final_optimization()
    finally:
        torch.set_num_threads(threads)
    path = tmp_path_factory.mktemp("state") / "state.pbstream"
    path.write_bytes(mb.serialize_state())
    return str(path)


def run_main(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) in (0, None)
    return capsys.readouterr().out


def records(reader_type, path):
    with open(path, "rb") as f:
        return list(reader_type(io.BytesIO(f.read())))


@pytest.mark.parametrize("which", ["golden", "port_state"])
def test_pbstream_info_equals_the_jax_main(which, port_state, capsys):
    path = GOLDEN if which == "golden" else port_state
    ours = run_main(pbstream_main.main, ["info", path], capsys)
    assert ours == run_main(jpbstream.main, ["info", path], capsys)
    info = json.loads(ours)
    assert info["payload"] == ("proto" if which == "golden" else "npz")
    assert sum(info["record_counts"].values()) > 0


@pytest.mark.parametrize("which", ["golden", "port_state"])
def test_pbstream_migrate_equals_the_jax_main(which, port_state, tmp_path, capsys):
    """Both mains migrate the same stream to the same records (compared
    after decompression: the container's gzip headers stamp the time)."""
    path = GOLDEN if which == "golden" else port_state
    ours, theirs = str(tmp_path / "ours.pbstream"), str(tmp_path / "theirs.pbstream")
    run_main(pbstream_main.main, ["migrate", path, ours], capsys)
    run_main(jpbstream.main, ["migrate", path, theirs], capsys)
    assert records(ProtoStreamReader, ours) == records(JReader, theirs)
    if which == "port_state":  # an npz state's records are rewritten unchanged
        assert records(ProtoStreamReader, ours) == records(ProtoStreamReader, path)


def test_ground_truth_and_relations_metrics_equal_the_jax_mains(port_state, tmp_path, capsys):
    """Both packages' mains on one port-written state: the same relations
    (arrays equal) and the same metrics text, the port's on the CPU."""
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    base = ["--pose_graph_filename", port_state] + GT_FLAGS
    said = run_main(ground_truth.main, base + ["--output_filename", ours, "--device", "cpu"], capsys)
    assert said == run_main(jground_truth.main, base + ["--output_filename", theirs], capsys)
    a, b = np.load(ours), np.load(theirs)
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert len(a["timestamp1"]) >= 1
    metrics = run_main(relations.main, ["--pose_graph_filename", port_state,
                                        "--relations_filename", ours, "--device", "cpu"], capsys)
    assert metrics == run_main(jrelations.main, ["--pose_graph_filename", port_state,
                                                 "--relations_filename", theirs], capsys)
    assert metrics.startswith("Abs translational error")
    empty = relations_metric.compute_relations_metrics([], [0.0], [np.zeros(7)])
    assert empty.num_relations == 0 and empty.abs_translational_error_mean == 0.0


def test_tool_mains_default_to_cuda(port_state, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = str(tmp_path)
    basename = write_server_configuration(d)
    mains = [
        (ground_truth.main, ["--pose_graph_filename", port_state, "--output_filename",
                             str(tmp_path / "gt.npz")]),
        (relations.main, ["--pose_graph_filename", port_state, "--relations_filename",
                          str(tmp_path / "gt.npz")]),
        (server_main.main, ["--configuration_directory", d, "--configuration_basename",
                            basename]),
    ]
    np.savez(str(tmp_path / "gt.npz"), timestamp1=np.zeros(0), timestamp2=np.zeros(0),
             expected=np.zeros((0, 7)), covered_distance=np.zeros(0))
    for main, argv in mains:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_print_configuration_equals_the_jax_main(tmp_path, capsys):
    d = str(tmp_path)
    basename = write_server_configuration(d)
    for extra in ([], ["--subdictionary", "MAP_BUILDER_SERVER.map_builder.pose_graph"]):
        argv = ["--configuration_directory", d, "--configuration_basename", basename] + extra
        ours = run_main(print_configuration.main, argv, capsys)
        assert ours == run_main(jprint.main, argv, capsys)
        table = json.loads(ours)
        assert ("optimize_every_n_nodes" in table) == bool(extra)


def test_server_main_serves_and_shuts_down_cleanly(tmp_path):
    """tools/map_builder_server_main with --device cpu as a subprocess on
    written Lua files: prints its port, builds nodes from scans sent
    through the stub, exits 0 on SIGINT."""
    d = str(tmp_path)
    basename = write_server_configuration(d)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cartographer_tpu_torch.tools.map_builder_server_main",
         "--configuration_directory", d, "--configuration_basename", basename,
         "--monitoring_port", "0", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert "listening on port" in line, line
        port = int(line.strip().rsplit(" ", 1)[-1])
        stub = MapBuilderStub(f"localhost:{port}")
        tid = stub.add_trajectory_builder({"range"}, trajectory_options(tconfig))
        builder = stub.get_trajectory_builder(tid)
        for m in generate_fake_range_measurements(
                translation=np.array([0.5, 0.25, 0.0]), duration=2.0, time_step=0.1):
            builder.add_sensor_data("range", m)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and len(stub.pose_graph.get_trajectory_node_poses()) <= 3:
            time.sleep(0.2)
        stub.finish_trajectory(tid)
        assert len(stub.pose_graph.get_trajectory_node_poses()) > 3
        stub.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
