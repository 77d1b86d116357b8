"""Ground-truth relations extraction CLI
(reference: ground_truth/autogenerate_ground_truth_main.cc:31-77).

Port of cartographer_tpu/tools/autogenerate_ground_truth_main.py.

Usage:
    python -m cartographer_tpu_torch.tools.autogenerate_ground_truth_main \
        --pose_graph_filename state.pbstream --output_filename gt.npz \
        [--min_covered_distance 100] [--outlier_threshold_meters 0.15] \
        [--outlier_threshold_radians 0.02]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pose_graph_filename", required=True)
    parser.add_argument("--output_filename", required=True)
    parser.add_argument("--min_covered_distance", type=float, default=100.0)
    parser.add_argument("--outlier_threshold_meters", type=float, default=0.15)
    parser.add_argument("--outlier_threshold_radians", type=float, default=0.02)
    parser.add_argument(
        "--device", default="cuda", help="Device of the MapBuilder (cuda or cpu)."
    )
    args = parser.parse_args(argv)

    from cartographer_tpu_torch.common.config import MapBuilderOptions
    from cartographer_tpu_torch.evaluation.relations_metric import generate_ground_truth
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    with open(args.pose_graph_filename, "rb") as f:
        state = f.read()
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device=args.device)
    mb.load_state(state, load_frozen_state=True)
    relations = generate_ground_truth(
        mb.pose_graph,
        min_covered_distance=args.min_covered_distance,
        outlier_threshold_meters=args.outlier_threshold_meters,
        outlier_threshold_radians=args.outlier_threshold_radians,
    )
    np.savez(
        args.output_filename,
        timestamp1=np.array([r.timestamp1 for r in relations]),
        timestamp2=np.array([r.timestamp2 for r in relations]),
        expected=np.stack([r.expected for r in relations])
        if relations
        else np.zeros((0, 7)),
        covered_distance=np.array([r.covered_distance for r in relations]),
    )
    print(f"Generated {len(relations)} relations.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
