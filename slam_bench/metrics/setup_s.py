"""Seconds from the process's start to the first measured revolution:
imports, the CUDA context, the stream's generation, the builds of the
program's kernels and the warm-up to two active submaps."""


def read(record):
    return record["setup_s"]
