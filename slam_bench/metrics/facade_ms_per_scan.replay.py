"""The facade's own time per revolution: spans around the trajectory
builder's `add_sensor_data` (MapBuilder, the sensor collator, the pose
graph's add_node, the result callback) minus the local trajectory
builder's spans inside them, over the window, per revolution completed
in it."""

from slam_bench import layers


def read(record):
    own = layers.span_s(record, "facade") - layers.span_s(record, "local_slam")
    return layers.per_revolution_ms(record, own)
