"""The port's native host kernels (csrc/native.cc through native/) against
the JAX package's native build, bit for bit, and against the numpy
oracles of tests/test_native.py; the voxel filter and the rotational
histogram reach them; a failed build raises instead of falling back."""

import numpy as np
import pytest

from cartographer_tpu import native as jnative
from cartographer_tpu.ops.scan_matching import rotational_histogram as jrh
from cartographer_tpu.sensor.voxel_filter import _voxel_keys
from cartographer_tpu_torch import native as tnative
from cartographer_tpu_torch.kernels import _build
from cartographer_tpu_torch.ops.scan_matching import rotational_histogram as trh
from cartographer_tpu_torch.sensor import voxel_filter as tvf


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    assert jnative.available(), "the JAX package's native library must build here"


def numpy_voxel_mask(points, resolution):
    """tests/test_native.py's oracle: the numpy first-occurrence filter."""
    keys = _voxel_keys(points, resolution)
    mask = np.zeros(len(points), bool)
    mask[np.unique(keys, return_index=True)[1]] = True
    return mask


@pytest.mark.parametrize("n,resolution", [(5000, 0.5), (1575, 0.05), (600, 0.2)])
def test_voxel_filter_indices_matches_jax_native(n, resolution):
    pts = np.random.default_rng(n).uniform(-20, 20, (n, 3)).astype(np.float32)
    mask = tnative.voxel_filter_indices(pts, resolution)
    np.testing.assert_array_equal(mask, jnative.voxel_filter_indices(pts, resolution))
    np.testing.assert_array_equal(mask, numpy_voxel_mask(pts, resolution))
    assert tnative.voxel_filter_indices(pts[:0], resolution).shape == (0,)


@pytest.mark.parametrize(
    "begin,end",
    [([500, 500], [500, 10500]), ([500, 500], [10500, 7500]),
     ([10500, 7500], [500, 500]), ([-500, 500], [9500, -6500]),
     ([100, 100], [900, 900])],
)
def test_ray_to_pixel_mask_matches_jax_native(begin, end):
    got = tnative.ray_to_pixel_mask(np.asarray(begin), np.asarray(end), 1000)
    np.testing.assert_array_equal(
        got, jnative.ray_to_pixel_mask(np.asarray(begin), np.asarray(end), 1000))
    # tests/test_native.py's oracle: every densely sampled pixel is listed.
    listed = {tuple(p) for p in got}
    assert len(listed) == len(got)
    b, e = np.asarray(begin, np.float64), np.asarray(end, np.float64)
    for t in np.linspace(0.0, 1.0, 500):
        assert tuple(np.floor((b + t * (e - b)) / 1000).astype(int)) in listed


def test_accumulate_cells_2d_matches_jax_native():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-3.0, 40.0, (3000, 2)).astype(np.float32)
    grid = tnative.accumulate_cells_2d(pts, 30, 35)
    np.testing.assert_array_equal(grid, jnative.accumulate_cells_2d(pts, 30, 35))
    ix, iy = np.floor(pts[:, 0]).astype(int), np.floor(pts[:, 1]).astype(int)
    m = (ix >= 0) & (ix < 35) & (iy >= 0) & (iy < 30)
    oracle = np.zeros((30, 35), np.int32)
    np.add.at(oracle, (iy[m], ix[m]), 1)
    np.testing.assert_array_equal(grid, oracle)
    assert tnative.accumulate_cells_2d(pts[:0], 3, 4).sum() == 0


@pytest.mark.parametrize("n", [0, 1, 3, 50, 800, 3000])
def test_rotational_histogram_matches_jax_native(n):
    rng = np.random.default_rng(7 + n)
    pts = rng.normal(0.0, 3.0, (n, 3)).astype(np.float32)
    if n:
        pts[:, 2] = rng.normal(0.0, 1.0, n)
    hist = tnative.rotational_histogram(pts, 120)
    np.testing.assert_array_equal(
        hist, jnative.rotational_histogram(pts, 120) if n else np.zeros(120, np.float32))
    np.testing.assert_allclose(hist, trh.compute_histogram_numpy(pts, 120), atol=1e-5)
    np.testing.assert_array_equal(hist, trh.compute_histogram(pts, 120))
    np.testing.assert_array_equal(
        trh.compute_histogram(pts, 120), jrh.compute_histogram(pts, 120))


def test_callers_reach_the_native_code(monkeypatch):
    calls = []

    def counted(name):
        real = getattr(tnative, name)

        def wrapper(*args):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(tnative, name, wrapper)

    counted("voxel_filter_indices")
    counted("rotational_histogram")
    rng = np.random.default_rng(1)
    big = rng.uniform(-10, 10, (513, 3)).astype(np.float32)
    small = big[:512]
    np.testing.assert_array_equal(
        tvf.voxel_filter_indices(big, 0.3), numpy_voxel_mask(big, 0.3))
    assert calls == ["voxel_filter_indices"]
    tvf.voxel_filter_indices(small, 0.3)  # the JAX threshold: numpy up to 512
    assert calls == ["voxel_filter_indices"]
    trh.compute_histogram(big, 64)
    assert calls == ["voxel_filter_indices", "rotational_histogram"]


def test_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    """A compiler that fails: the loader raises with the compiler's output,
    and the voxel filter and the histogram raise with it (the JAX
    package's loader would return None and drop to numpy)."""
    failing = tmp_path / "failing-cxx"
    failing.write_text("#!/bin/sh\necho 'native.cc: error: no compiler here' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "_host_cxx", lambda: str(failing))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(tnative, "_lib", None)
    pts = np.random.default_rng(2).uniform(-5, 5, (600, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no compiler here"):
        tnative.rotational_histogram(pts, 64)
    with pytest.raises(RuntimeError, match=r"building csrc/native.cc failed"):
        tvf.voxel_filter_indices(pts, 0.2)
    with pytest.raises(RuntimeError, match="failed"):
        trh.compute_histogram(pts, 64)
    assert not list((tmp_path / "build").glob("*.so"))
