"""Generated protobuf module of the reference's pbstream schema, copied
byte for byte from cartographer_tpu/io/proto (state.proto, state_pb2.py)
so that both packages register one identical descriptor."""
