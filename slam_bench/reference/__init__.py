"""The plain reference that decides `correct`.

Plain PyTorch and numpy, frozen copies of the port's plain versions where
the timed path runs a kernel or a device loop in their place. Nothing
here imports `jax`, the JAX package or the program (`cartographer_tpu_torch`);
each function takes the inputs that the benchmark generated or that the
program handed over at a layer's boundary, and works out the rest itself.
"""
