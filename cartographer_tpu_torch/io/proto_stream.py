"""pbstream container: the reference's exact on-disk framing.

Copy of cartographer_tpu/io/proto_stream.py (standard library only).

Reference: io/proto_stream.cc:26-100 — magic 0x7b1d1f7b5bf501db as 8
little-endian bytes, then per record: little-endian uint64 compressed size +
gzip-compressed payload. This module reproduces the framing byte-for-byte;
the payloads are npz records (io/serialization.py) or the reference's
protobuf messages (io/pbstream_compat.py).
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO, Iterator, Optional

MAGIC = 0x7B1D1F7B5BF501DB


class ProtoStreamWriter:
    def __init__(self, fileobj_or_path):
        if hasattr(fileobj_or_path, "write"):
            self._out: BinaryIO = fileobj_or_path
            self._owns = False
        else:
            self._out = open(fileobj_or_path, "wb")
            self._owns = True
        self._out.write(struct.pack("<Q", MAGIC))

    def write(self, uncompressed_data: bytes) -> None:
        compressed = gzip.compress(uncompressed_data)
        self._out.write(struct.pack("<Q", len(compressed)))
        self._out.write(compressed)

    def close(self) -> None:
        if self._owns:
            self._out.close()


class ProtoStreamReader:
    def __init__(self, fileobj_or_path):
        if hasattr(fileobj_or_path, "read"):
            self._in: BinaryIO = fileobj_or_path
            self._owns = False
        else:
            self._in = open(fileobj_or_path, "rb")
            self._owns = True
        header = self._in.read(8)
        if len(header) != 8 or struct.unpack("<Q", header)[0] != MAGIC:
            raise ValueError("Not a pbstream: bad magic.")

    def read(self) -> Optional[bytes]:
        size_bytes = self._in.read(8)
        if len(size_bytes) < 8:
            return None
        (size,) = struct.unpack("<Q", size_bytes)
        compressed = self._in.read(size)
        if len(compressed) < size:
            return None
        return gzip.decompress(compressed)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            record = self.read()
            if record is None:
                return
            yield record

    def close(self) -> None:
        if self._owns:
            self._in.close()
