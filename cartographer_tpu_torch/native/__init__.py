"""Host-side C++ helpers built at first use and loaded with ctypes
(port of cartographer_tpu.native)."""
