"""Saving, loading and offline processing of SLAM state (port of
cartographer_tpu.io). Only serialization's pbstream_info and
pbstream_compat import google.protobuf (through proto/state_pb2)."""
