"""cartographer_tpu_torch: the PyTorch/CUDA port of cartographer_tpu.

The JAX package `cartographer_tpu` is the reference; this package computes
the same functions with PyTorch tensors, and its device kernels are
hand-written CUDA for Hopper (`csrc/`, built at first use by
`kernels/_build.py`). It imports neither JAX nor any module of the JAX
package: the pure-Python modules it needs are copied under the same
relative paths.

Every module of the JAX package has its counterpart: 2D and 3D local
SLAM, per scan (`mapping/local_trajectory_builder_2d`, `_3d`) or chunked
(`mapping/chunked_frontend_2d`, `_3d` over `ops/frontend_2d`, `_3d`),
the pose graphs with loop closure, SPA and the trimmers under
`mapping/map_builder.MapBuilder`, saved maps (`io/`), the cloud server
(`cloud/`), the tool mains (`tools/`) and the multi-rank backend
(`parallel/`: the loop-closure search batches and the SPA solves split
over torch.distributed ranks). Entry points run on CUDA unless the caller
passes `device="cpu"`.
"""

__version__ = "0.1.0"
