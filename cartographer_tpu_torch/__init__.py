"""cartographer_tpu_torch: the PyTorch/CUDA port of cartographer_tpu.

The JAX package `cartographer_tpu` is the reference; this package computes
the same functions with PyTorch tensors, and its device kernels are
hand-written CUDA for Hopper (`csrc/`, built at first use by
`kernels/_build.py`). It imports neither JAX nor any module of the JAX
package: the pure-Python modules it needs are copied under the same
relative paths.

Ported so far: 2D SLAM from scans to an optimized map. Local SLAM runs
per scan (`mapping/local_trajectory_builder_2d.LocalTrajectoryBuilder2D`,
the default, on probability grids or TSDFs) or chunked
(`mapping/chunked_frontend_2d.ChunkedLocalTrajectoryBuilder2D` over
`ops/frontend_2d.run_chunk`), with IMU and odometry fusion and online
correlative matching; behind it the pose graph with loop closure, SPA and
the trimmers, under `mapping/map_builder.MapBuilder`. 3D local SLAM runs
per scan (`mapping/local_trajectory_builder_3d.LocalTrajectoryBuilder3D`,
dense or paged voxel grids, IMU, intensities, online correlative
matching) or chunked (`mapping/chunked_frontend_3d
.ChunkedLocalTrajectoryBuilder3D` over `ops/frontend_3d.run_chunk`); the
3D backend and MapBuilder's 3D route are not ported yet. Entry points run
on CUDA unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
