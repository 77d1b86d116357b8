"""The port's Lua evaluator and configuration loader against the JAX
package, on Lua texts the tests write: the same tables and the same
exception types, the same typed options, and the same server options
from one configuration set."""

import math

import pytest

from cartographer_tpu.common import config as jconfig
from cartographer_tpu.common import lua as jlua
from cartographer_tpu.common import lua_config as jlua_config
from cartographer_tpu.tools.map_builder_server_main import load_server_options as jload_server
from cartographer_tpu_torch.common import config as tconfig
from cartographer_tpu_torch.common import lua as tlua
from cartographer_tpu_torch.common import lua_config as tlua_config
from cartographer_tpu_torch.testing.server_config import write_server_configuration
from cartographer_tpu_torch.tools.map_builder_server_main import load_server_options

CODE = {
    "strings_with_comment_markers": (
        'options = { tag = "a--b;c", other = \'semi;colon\' }\n'
        "options.x = 1 -- real comment = ignored\n"
    ),
    "long_comments_multiline_expressions": (
        "--[[ a long\n comment with options = {} inside ]]\n"
        "options = {\n  value = 1.0 +\n          2.0 * 3.0,\n"
        "  angle = math.rad(90.),\n  neg = -2 ^ 2,\n}\n"
    ),
    "arithmetic_on_subtables": (
        "BASE = { resolution = 0.05, count = 4 }\n"
        "DERIVED = { cells = 2 / BASE.resolution + BASE.count, half = BASE.count % 3 }\n"
    ),
    "return_chunk": "return { blah = 100, nested = { 1, 2, three = 3 } }",
    "concatenation_and_locals": (
        'local prefix = "map_"\noptions = { name = prefix .. "builder" .. 2, '
        "flag = not false and true, none = nil }\n"
    ),
    "arrays_and_booleans": "T = { 1.5, 2, { x = true }, false, 'str' }\n",
}


@pytest.mark.parametrize("name", sorted(CODE))
def test_load_lua_code_equals_the_jax_package(name):
    assert tlua_config.load_lua_code(CODE[name]) == jlua_config.load_lua_code(CODE[name])


@pytest.mark.parametrize("code", [
    "function f() return 1 end",
    "for i = 1, 3 do x = i end",
    "x = {",
    'x = "unterminated',
    "x = undefined_name.field",
])
def test_unsupported_lua_raises_the_same_type(code):
    errors = []
    for mod in (jlua_config, tlua_config):
        with pytest.raises(Exception) as info:
            mod.load_lua_code(code)
        errors.append(info.value)
    assert type(errors[1]).__name__ == type(errors[0]).__name__
    assert isinstance(errors[1], tlua.LuaError) == isinstance(errors[0], jlua.LuaError)
    assert str(errors[1]) == str(errors[0])


def test_nested_includes_and_unread_keys(tmp_path):
    """Includes three deep, and the typo defense: an unread key raises
    LuaConfigError in both packages (naming the key), non-strict loading
    gives equal options."""
    d = str(tmp_path)
    (tmp_path / "base.lua").write_text("BASE = { value = 1 }\n")
    (tmp_path / "mid.lua").write_text('include "base.lua"\nBASE.value = BASE.value + 1\n')
    (tmp_path / "top.lua").write_text('include "mid.lua"\nTOP = { v = BASE.value * 10 }\n')
    assert tlua_config.load_lua_file("top.lua", [d]) == jlua_config.load_lua_file("top.lua", [d])
    assert tlua_config.load_lua_file("top.lua", [d])["TOP"]["v"] == 20.0

    write_server_configuration(d)
    (tmp_path / "typo.lua").write_text(
        'include "map_builder.lua"\nMAP_BUILDER.use_trajectory_builder_2d = true\n'
        "MAP_BUILDER.nmu_background_threads = 4\n")
    for mod in (jlua_config, tlua_config):
        with pytest.raises(mod.LuaConfigError, match="nmu_background"):
            mod.load_map_builder_options("typo.lua", include_dirs=[d])
    loose = [mod.load_map_builder_options("typo.lua", include_dirs=[d], strict=False)
             for mod in (jlua_config, tlua_config)]
    assert loose[1].to_dict() == loose[0].to_dict()
    (tmp_path / "frac.lua").write_text(
        'include "map_builder.lua"\nMAP_BUILDER.num_background_threads = 4.5\n')
    for mod in (jlua_config, tlua_config):
        with pytest.raises(ValueError, match="num_background_threads"):
            mod.load_map_builder_options("frac.lua", include_dirs=[d])
    with pytest.raises(FileNotFoundError):
        tlua_config.load_lua_file("missing.lua", [d])


TRAJECTORY_BUILDER_LUA = """\
TRAJECTORY_BUILDER = {
  trajectory_builder_2d = {
    use_imu_data = false,
    min_range = 0.2,
    max_range = 12.,
    num_accumulated_range_data = 1,
    voxel_filter_size = 0.025,
    use_online_correlative_scan_matching = true,
    real_time_correlative_scan_matcher = {
      linear_search_window = 0.1,
      angular_search_window = math.rad(20.),
    },
    motion_filter = { max_time_seconds = 5., max_distance_meters = 0.2,
                      max_angle_radians = math.rad(1.) },
    submaps = {
      num_range_data = 40,
      grid_options_2d = { grid_type = "PROBABILITY_GRID", resolution = 0.05 },
    },
  },
  trajectory_builder_3d = {
    max_range = 60.,
    submaps = { high_resolution = 0.10, low_resolution = 0.45, num_range_data = 160 },
  },
  pure_localization_trimmer = { max_submaps_to_keep = 3 },
  collate_landmarks = false,
}
"""


def test_typed_options_equal_the_jax_package(tmp_path):
    d = str(tmp_path)
    write_server_configuration(d)
    (tmp_path / "trajectory_builder.lua").write_text(TRAJECTORY_BUILDER_LUA)
    (tmp_path / "map_builder_2d.lua").write_text(
        'include "map_builder.lua"\nMAP_BUILDER.use_trajectory_builder_2d = true\n'
        "MAP_BUILDER.pose_graph.optimize_every_n_nodes = 40\n")
    for name in ("map_builder.lua", "map_builder_2d.lua"):
        ours = tlua_config.load_map_builder_options(name, include_dirs=[d])
        theirs = jlua_config.load_map_builder_options(name, include_dirs=[d])
        assert isinstance(ours, tconfig.MapBuilderOptions)
        assert ours.to_dict() == theirs.to_dict()
    ours = tlua_config.load_trajectory_builder_options("trajectory_builder.lua", include_dirs=[d])
    theirs = jlua_config.load_trajectory_builder_options("trajectory_builder.lua", include_dirs=[d])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.trajectory_builder_2d.real_time_correlative_scan_matcher.angular_search_window == (
        pytest.approx(math.radians(20.0)))
    assert ours.pure_localization_trimmer.max_submaps_to_keep == 3
    assert isinstance(ours.trajectory_builder_2d.submaps.num_range_data, int)
    # The written set gives the typed defaults.
    assert tlua_config.load_map_builder_options("map_builder.lua", include_dirs=[d]).to_dict() == (
        tconfig.MapBuilderOptions().to_dict())


@pytest.mark.parametrize("uplink", ["", "localhost:1234"])
def test_load_server_options_equals_the_jax_package(tmp_path, uplink):
    d = str(tmp_path)
    basename = write_server_configuration(d, server_address="localhost:0")
    (tmp_path / "server_test.lua").write_text(
        f'include "{basename}"\nMAP_BUILDER_SERVER.uplink_server_address = "{uplink}"\n'
        "MAP_BUILDER_SERVER.upload_batch_size = 25\n")
    ours = load_server_options("server_test.lua", [d])
    theirs = jload_server("server_test.lua", [d])
    assert ours[0].to_dict() == theirs[0].to_dict()
    assert ours[1:] == theirs[1:] == ("localhost:0", uplink or None, 25)
    assert ours[0].use_trajectory_builder_2d and ours[0].collate_by_trajectory
    assert isinstance(ours[0], tconfig.MapBuilderOptions)
    assert isinstance(theirs[0], jconfig.MapBuilderOptions)


def test_only_the_callers_directories_are_searched(tmp_path, monkeypatch):
    """The port adds no search path of its own: a file is found in the
    caller's directories or not at all, wherever the process runs."""
    assert tlua_config._REFERENCE_DIRS == []
    (tmp_path / "map_builder.lua").write_text(
        "MAP_BUILDER = { use_trajectory_builder_3d = true, num_background_threads = 2 }\n")
    opts = tlua_config.load_map_builder_options("map_builder.lua", include_dirs=[str(tmp_path)])
    assert opts.use_trajectory_builder_3d and opts.num_background_threads == 2
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    monkeypatch.chdir(elsewhere)
    with pytest.raises(FileNotFoundError):
        tlua_config.load_map_builder_options("map_builder.lua", include_dirs=[str(elsewhere)])
