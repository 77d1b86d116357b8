# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cartographer_tpu/io/proto/state.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n%cartographer_tpu/io/proto/state.proto\x12\x16\x63\x61rtographer_tpu.proto\" \n\x08Vector2d\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\"+\n\x08Vector3d\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\"+\n\x08Vector3f\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"9\n\x0bQuaterniond\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\x12\t\n\x01w\x18\x04 \x01(\x01\"w\n\x07Rigid3d\x12\x35\n\x0btranslation\x18\x01 \x01(\x0b\x32 .cartographer_tpu.proto.Vector3d\x12\x35\n\x08rotation\x18\x02 \x01(\x0b\x32#.cartographer_tpu.proto.Quaterniond\">\n\x14\x43ompressedPointCloud\x12\x12\n\nnum_points\x18\x01 \x01(\x05\x12\x12\n\npoint_data\x18\x03 \x03(\x05\"\x9c\x01\n\x0cImuDataProto\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12=\n\x13linear_acceleration\x18\x02 \x01(\x0b\x32 .cartographer_tpu.proto.Vector3d\x12:\n\x10\x61ngular_velocity\x18\x03 \x01(\x0b\x32 .cartographer_tpu.proto.Vector3d\"U\n\x11OdometryDataProto\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12-\n\x04pose\x18\x02 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\"[\n\x17\x46ixedFramePoseDataProto\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12-\n\x04pose\x18\x02 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\"\xa6\x02\n\x11LandmarkDataProto\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12\\\n\x15landmark_observations\x18\x02 \x03(\x0b\x32=.cartographer_tpu.proto.LandmarkDataProto.LandmarkObservation\x1a\x9f\x01\n\x13LandmarkObservation\x12\n\n\x02id\x18\x01 \x01(\x0c\x12G\n\x1elandmark_to_tracking_transform\x18\x02 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\x12\x1a\n\x12translation_weight\x18\x03 \x01(\x01\x12\x17\n\x0frotation_weight\x18\x04 \x01(\x01\"7\n\x08SubmapId\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12\x14\n\x0csubmap_index\x18\x02 \x01(\x05\"3\n\x06NodeId\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12\x12\n\nnode_index\x18\x02 \x01(\x05\"\xc2\x02\n\nTrajectory\x12\x15\n\rtrajectory_id\x18\x03 \x01(\x05\x12\x35\n\x04node\x18\x01 \x03(\x0b\x32\'.cartographer_tpu.proto.Trajectory.Node\x12\x39\n\x06submap\x18\x02 \x03(\x0b\x32).cartographer_tpu.proto.Trajectory.Submap\x1a\\\n\x04Node\x12\x12\n\nnode_index\x18\x07 \x01(\x05\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12-\n\x04pose\x18\x05 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\x1aM\n\x06Submap\x12\x14\n\x0csubmap_index\x18\x02 \x01(\x05\x12-\n\x04pose\x18\x01 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\"\xf4\x04\n\tPoseGraph\x12@\n\nconstraint\x18\x02 \x03(\x0b\x32,.cartographer_tpu.proto.PoseGraph.Constraint\x12\x36\n\ntrajectory\x18\x04 \x03(\x0b\x32\".cartographer_tpu.proto.Trajectory\x12\x46\n\x0elandmark_poses\x18\x05 \x03(\x0b\x32..cartographer_tpu.proto.PoseGraph.LandmarkPose\x1a\xc9\x02\n\nConstraint\x12\x33\n\tsubmap_id\x18\x01 \x01(\x0b\x32 .cartographer_tpu.proto.SubmapId\x12/\n\x07node_id\x18\x02 \x01(\x0b\x32\x1e.cartographer_tpu.proto.NodeId\x12\x36\n\rrelative_pose\x18\x03 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\x12\x1a\n\x12translation_weight\x18\x06 \x01(\x01\x12\x17\n\x0frotation_weight\x18\x07 \x01(\x01\x12=\n\x03tag\x18\x05 \x01(\x0e\x32\x30.cartographer_tpu.proto.PoseGraph.Constraint.Tag\")\n\x03Tag\x12\x10\n\x0cINTRA_SUBMAP\x10\x00\x12\x10\n\x0cINTER_SUBMAP\x10\x01\x1aY\n\x0cLandmarkPose\x12\x13\n\x0blandmark_id\x18\x01 \x01(\t\x12\x34\n\x0bglobal_pose\x18\x02 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\"6\n\nCellLimits\x12\x13\n\x0bnum_x_cells\x18\x01 \x01(\x05\x12\x13\n\x0bnum_y_cells\x18\x02 \x01(\x05\"\x87\x01\n\tMapLimits\x12\x12\n\nresolution\x18\x01 \x01(\x01\x12-\n\x03max\x18\x02 \x01(\x0b\x32 .cartographer_tpu.proto.Vector2d\x12\x37\n\x0b\x63\x65ll_limits\x18\x03 \x01(\x0b\x32\".cartographer_tpu.proto.CellLimits\"\x19\n\x17ProbabilityGrid2DMarker\"U\n\x0cTSDF2DMarker\x12\x1b\n\x13truncation_distance\x18\x01 \x01(\x02\x12\x12\n\nmax_weight\x18\x02 \x01(\x02\x12\x14\n\x0cweight_cells\x18\x03 \x03(\x05\"\xa5\x03\n\x06Grid2D\x12\x31\n\x06limits\x18\x01 \x01(\x0b\x32!.cartographer_tpu.proto.MapLimits\x12\r\n\x05\x63\x65lls\x18\x02 \x03(\x05\x12?\n\x0fknown_cells_box\x18\x03 \x01(\x0b\x32&.cartographer_tpu.proto.Grid2D.CellBox\x12N\n\x13probability_grid_2d\x18\x04 \x01(\x0b\x32/.cartographer_tpu.proto.ProbabilityGrid2DMarkerH\x00\x12\x37\n\x07tsdf_2d\x18\x05 \x01(\x0b\x32$.cartographer_tpu.proto.TSDF2DMarkerH\x00\x12\x1f\n\x17min_correspondence_cost\x18\x06 \x01(\x02\x12\x1f\n\x17max_correspondence_cost\x18\x07 \x01(\x02\x1a\x45\n\x07\x43\x65llBox\x12\r\n\x05max_x\x18\x01 \x01(\x05\x12\r\n\x05max_y\x18\x02 \x01(\x05\x12\r\n\x05min_x\x18\x03 \x01(\x05\x12\r\n\x05min_y\x18\x04 \x01(\x05\x42\x06\n\x04grid\"i\n\nHybridGrid\x12\x12\n\nresolution\x18\x01 \x01(\x02\x12\x11\n\tx_indices\x18\x03 \x03(\x11\x12\x11\n\ty_indices\x18\x04 \x03(\x11\x12\x11\n\tz_indices\x18\x05 \x03(\x11\x12\x0e\n\x06values\x18\x06 \x03(\x05\"\x97\x01\n\x08Submap2D\x12\x33\n\nlocal_pose\x18\x01 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\x12\x16\n\x0enum_range_data\x18\x02 \x01(\x05\x12\x10\n\x08\x66inished\x18\x03 \x01(\x08\x12,\n\x04grid\x18\x04 \x01(\x0b\x32\x1e.cartographer_tpu.proto.Grid2D\"\xa5\x02\n\x08Submap3D\x12\x33\n\nlocal_pose\x18\x01 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\x12\x16\n\x0enum_range_data\x18\x02 \x01(\x05\x12\x10\n\x08\x66inished\x18\x03 \x01(\x08\x12G\n\x1bhigh_resolution_hybrid_grid\x18\x04 \x01(\x0b\x32\".cartographer_tpu.proto.HybridGrid\x12\x46\n\x1alow_resolution_hybrid_grid\x18\x05 \x01(\x0b\x32\".cartographer_tpu.proto.HybridGrid\x12)\n!rotational_scan_matcher_histogram\x18\x06 \x03(\x02\"\xc8\x03\n\x12TrajectoryNodeData\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12>\n\x11gravity_alignment\x18\x02 \x01(\x0b\x32#.cartographer_tpu.proto.Quaterniond\x12Z\n$filtered_gravity_aligned_point_cloud\x18\x03 \x01(\x0b\x32,.cartographer_tpu.proto.CompressedPointCloud\x12Q\n\x1bhigh_resolution_point_cloud\x18\x04 \x01(\x0b\x32,.cartographer_tpu.proto.CompressedPointCloud\x12P\n\x1alow_resolution_point_cloud\x18\x05 \x01(\x0b\x32,.cartographer_tpu.proto.CompressedPointCloud\x12)\n!rotational_scan_matcher_histogram\x18\x06 \x03(\x02\x12\x33\n\nlocal_pose\x18\x07 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\"\xa7\x01\n\x06Submap\x12\x33\n\tsubmap_id\x18\x01 \x01(\x0b\x32 .cartographer_tpu.proto.SubmapId\x12\x33\n\tsubmap_2d\x18\x02 \x01(\x0b\x32 .cartographer_tpu.proto.Submap2D\x12\x33\n\tsubmap_3d\x18\x03 \x01(\x0b\x32 .cartographer_tpu.proto.Submap3D\"v\n\x04Node\x12/\n\x07node_id\x18\x01 \x01(\x0b\x32\x1e.cartographer_tpu.proto.NodeId\x12=\n\tnode_data\x18\x05 \x01(\x0b\x32*.cartographer_tpu.proto.TrajectoryNodeData\"X\n\x07ImuData\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12\x36\n\x08imu_data\x18\x02 \x01(\x0b\x32$.cartographer_tpu.proto.ImuDataProto\"g\n\x0cOdometryData\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12@\n\rodometry_data\x18\x02 \x01(\x0b\x32).cartographer_tpu.proto.OdometryDataProto\"{\n\x12\x46ixedFramePoseData\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12N\n\x15\x66ixed_frame_pose_data\x18\x02 \x01(\x0b\x32/.cartographer_tpu.proto.FixedFramePoseDataProto\"g\n\x0cLandmarkData\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12@\n\rlandmark_data\x18\x02 \x01(\x0b\x32).cartographer_tpu.proto.LandmarkDataProto\"\xc3\x01\n\x0eTrajectoryData\x12\x15\n\rtrajectory_id\x18\x01 \x01(\x05\x12\x18\n\x10gravity_constant\x18\x02 \x01(\x01\x12<\n\x0fimu_calibration\x18\x03 \x01(\x0b\x32#.cartographer_tpu.proto.Quaterniond\x12\x42\n\x19\x66ixed_frame_origin_in_map\x18\x04 \x01(\x0b\x32\x1f.cartographer_tpu.proto.Rigid3d\"-\n\x13SerializationHeader\x12\x16\n\x0e\x66ormat_version\x18\x01 \x01(\r\" \n\rOpaqueOptions\x12\x0f\n\x07payload\x18\x63 \x01(\x0c\"\xc5\x04\n\x0eSerializedData\x12\x37\n\npose_graph\x18\x01 \x01(\x0b\x32!.cartographer_tpu.proto.PoseGraphH\x00\x12O\n\x1e\x61ll_trajectory_builder_options\x18\x02 \x01(\x0b\x32%.cartographer_tpu.proto.OpaqueOptionsH\x00\x12\x30\n\x06submap\x18\x03 \x01(\x0b\x32\x1e.cartographer_tpu.proto.SubmapH\x00\x12,\n\x04node\x18\x04 \x01(\x0b\x32\x1c.cartographer_tpu.proto.NodeH\x00\x12\x41\n\x0ftrajectory_data\x18\x05 \x01(\x0b\x32&.cartographer_tpu.proto.TrajectoryDataH\x00\x12\x33\n\x08imu_data\x18\x06 \x01(\x0b\x32\x1f.cartographer_tpu.proto.ImuDataH\x00\x12=\n\rodometry_data\x18\x07 \x01(\x0b\x32$.cartographer_tpu.proto.OdometryDataH\x00\x12K\n\x15\x66ixed_frame_pose_data\x18\x08 \x01(\x0b\x32*.cartographer_tpu.proto.FixedFramePoseDataH\x00\x12=\n\rlandmark_data\x18\t \x01(\x0b\x32$.cartographer_tpu.proto.LandmarkDataH\x00\x42\x06\n\x04\x64\x61tab\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cartographer_tpu.io.proto.state_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTOR2D._serialized_start=65
  _VECTOR2D._serialized_end=97
  _VECTOR3D._serialized_start=99
  _VECTOR3D._serialized_end=142
  _VECTOR3F._serialized_start=144
  _VECTOR3F._serialized_end=187
  _QUATERNIOND._serialized_start=189
  _QUATERNIOND._serialized_end=246
  _RIGID3D._serialized_start=248
  _RIGID3D._serialized_end=367
  _COMPRESSEDPOINTCLOUD._serialized_start=369
  _COMPRESSEDPOINTCLOUD._serialized_end=431
  _IMUDATAPROTO._serialized_start=434
  _IMUDATAPROTO._serialized_end=590
  _ODOMETRYDATAPROTO._serialized_start=592
  _ODOMETRYDATAPROTO._serialized_end=677
  _FIXEDFRAMEPOSEDATAPROTO._serialized_start=679
  _FIXEDFRAMEPOSEDATAPROTO._serialized_end=770
  _LANDMARKDATAPROTO._serialized_start=773
  _LANDMARKDATAPROTO._serialized_end=1067
  _LANDMARKDATAPROTO_LANDMARKOBSERVATION._serialized_start=908
  _LANDMARKDATAPROTO_LANDMARKOBSERVATION._serialized_end=1067
  _SUBMAPID._serialized_start=1069
  _SUBMAPID._serialized_end=1124
  _NODEID._serialized_start=1126
  _NODEID._serialized_end=1177
  _TRAJECTORY._serialized_start=1180
  _TRAJECTORY._serialized_end=1502
  _TRAJECTORY_NODE._serialized_start=1331
  _TRAJECTORY_NODE._serialized_end=1423
  _TRAJECTORY_SUBMAP._serialized_start=1425
  _TRAJECTORY_SUBMAP._serialized_end=1502
  _POSEGRAPH._serialized_start=1505
  _POSEGRAPH._serialized_end=2133
  _POSEGRAPH_CONSTRAINT._serialized_start=1713
  _POSEGRAPH_CONSTRAINT._serialized_end=2042
  _POSEGRAPH_CONSTRAINT_TAG._serialized_start=2001
  _POSEGRAPH_CONSTRAINT_TAG._serialized_end=2042
  _POSEGRAPH_LANDMARKPOSE._serialized_start=2044
  _POSEGRAPH_LANDMARKPOSE._serialized_end=2133
  _CELLLIMITS._serialized_start=2135
  _CELLLIMITS._serialized_end=2189
  _MAPLIMITS._serialized_start=2192
  _MAPLIMITS._serialized_end=2327
  _PROBABILITYGRID2DMARKER._serialized_start=2329
  _PROBABILITYGRID2DMARKER._serialized_end=2354
  _TSDF2DMARKER._serialized_start=2356
  _TSDF2DMARKER._serialized_end=2441
  _GRID2D._serialized_start=2444
  _GRID2D._serialized_end=2865
  _GRID2D_CELLBOX._serialized_start=2788
  _GRID2D_CELLBOX._serialized_end=2857
  _HYBRIDGRID._serialized_start=2867
  _HYBRIDGRID._serialized_end=2972
  _SUBMAP2D._serialized_start=2975
  _SUBMAP2D._serialized_end=3126
  _SUBMAP3D._serialized_start=3129
  _SUBMAP3D._serialized_end=3422
  _TRAJECTORYNODEDATA._serialized_start=3425
  _TRAJECTORYNODEDATA._serialized_end=3881
  _SUBMAP._serialized_start=3884
  _SUBMAP._serialized_end=4051
  _NODE._serialized_start=4053
  _NODE._serialized_end=4171
  _IMUDATA._serialized_start=4173
  _IMUDATA._serialized_end=4261
  _ODOMETRYDATA._serialized_start=4263
  _ODOMETRYDATA._serialized_end=4366
  _FIXEDFRAMEPOSEDATA._serialized_start=4368
  _FIXEDFRAMEPOSEDATA._serialized_end=4491
  _LANDMARKDATA._serialized_start=4493
  _LANDMARKDATA._serialized_end=4596
  _TRAJECTORYDATA._serialized_start=4599
  _TRAJECTORYDATA._serialized_end=4794
  _SERIALIZATIONHEADER._serialized_start=4796
  _SERIALIZATIONHEADER._serialized_end=4841
  _OPAQUEOPTIONS._serialized_start=4843
  _OPAQUEOPTIONS._serialized_end=4875
  _SERIALIZEDDATA._serialized_start=4878
  _SERIALIZEDDATA._serialized_end=5459
# @@protoc_insertion_point(module_scope)
