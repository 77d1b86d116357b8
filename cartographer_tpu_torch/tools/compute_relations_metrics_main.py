"""Relations-metric evaluation CLI
(reference: ground_truth/compute_relations_metrics_main.cc:39-219).

Port of cartographer_tpu/tools/compute_relations_metrics_main.py.

Usage:
    python -m cartographer_tpu_torch.tools.compute_relations_metrics_main \
        --pose_graph_filename state.pbstream --relations_filename gt.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pose_graph_filename", required=True)
    parser.add_argument("--relations_filename", required=True)
    parser.add_argument(
        "--device", default="cuda", help="Device of the MapBuilder (cuda or cpu)."
    )
    args = parser.parse_args(argv)

    from cartographer_tpu_torch.common.config import MapBuilderOptions
    from cartographer_tpu_torch.evaluation.relations_metric import (
        Relation,
        compute_relations_metrics,
    )
    from cartographer_tpu_torch.mapping.id import NodeId
    from cartographer_tpu_torch.mapping.map_builder import MapBuilder

    with open(args.pose_graph_filename, "rb") as f:
        state = f.read()
    mb = MapBuilder(MapBuilderOptions(use_trajectory_builder_2d=True), device=args.device)
    mb.load_state(state, load_frozen_state=True)
    nodes = mb.pose_graph.get_trajectory_nodes()
    node_times, node_poses = [], []
    for node_id, node in nodes.items(NodeId):
        node_times.append(node.constant_data.time)
        node_poses.append(np.asarray(node.global_pose))

    gt = np.load(args.relations_filename)
    relations = [
        Relation(
            timestamp1=float(t1),
            timestamp2=float(t2),
            expected=np.asarray(e),
            covered_distance=float(d),
        )
        for t1, t2, e, d in zip(
            gt["timestamp1"], gt["timestamp2"], gt["expected"], gt["covered_distance"]
        )
    ]
    print(compute_relations_metrics(relations, node_times, node_poses))
    return 0


if __name__ == "__main__":
    sys.exit(main())
