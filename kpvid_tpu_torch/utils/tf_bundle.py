"""Read a TensorFlow checkpoint (a V2 tensor bundle) with numpy alone.

The port's counterpart of the ``tf.train.load_checkpoint`` read that
kpvid_tpu/utils/tf1_import.py makes: the machine with the card has no
TensorFlow. A bundle ``<prefix>`` is

- ``<prefix>.index``: a LevelDB-format table, sorted by key bytes. Its
  48-byte footer holds the block handles (varint64 offset and size) of the
  metaindex and index blocks, padding, and the magic ``0xdb4775248b80fb57``
  (little-endian). Each block ends in a 5-byte trailer: a compression byte
  (0, none, is what TensorFlow writes for bundles; any other is refused)
  and the masked crc32c of the block and that byte. A block's entries are
  prefix-compressed keys (varints ``shared``, ``non_shared``,
  ``value_len``) followed by the restart offsets and their count. The index
  block maps a key at or past each data block's last one to that block's
  handle;
- under the key ``""`` a ``BundleHeaderProto`` (``num_shards`` 1,
  ``endianness`` 2, ``version`` 3); under every other key, a tensor name, a
  ``BundleEntryProto`` (``dtype`` 1, ``shape`` 2, ``shard_id`` 3,
  ``offset`` 4, ``size`` 5, ``crc32c`` 6 (masked), ``slices`` 7), the field
  numbers of tensorflow/core/protobuf/tensor_bundle.proto;
- ``<prefix>.data-{shard:05d}-of-{num_shards:05d}``: the tensors' raw
  little-endian bytes.

Every block and every tensor is checked against its crc32c. float32,
float64, half, int32, int64 and bfloat16 tensors are read, scalars
included; bfloat16 comes back widened to float32, which is exact. A
big-endian bundle is refused when it is opened; a partitioned variable
(non-empty ``slices``), a string tensor or another dtype when it is read.
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_STRING, DT_INT64, DT_BFLOAT16, DT_HALF = 1, 2, 3, 7, 9, 14, 19
NUMPY_DTYPES = {DT_FLOAT: "<f4", DT_DOUBLE: "<f8", DT_INT32: "<i4", DT_INT64: "<i8",
                DT_HALF: "<f2", DT_BFLOAT16: "<u2"}
_CRC_POLY = 0x82F63B78  # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8


@functools.cache
def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_CRC_POLY), t >> 1).astype(np.uint32)
    return t


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The GF(2)-linear map with columns ``cols`` (uint32[32]) on each
    register of ``v``."""
    out = np.zeros_like(v)
    for i in range(32):
        out ^= np.where((v >> np.uint32(i)) & np.uint32(1), cols[i], np.uint32(0))
    return out


def _zeros_operator(n: int) -> np.ndarray:
    """The columns of the map a CRC register goes through over ``n`` zero
    bytes."""
    table = _crc_table()
    cols = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(n):
        cols = table[cols & np.uint32(0xFF)] ^ (cols >> np.uint32(8))
    return cols


def _crc_update(reg: int, data) -> int:
    table = _crc_table().tolist()
    for b in bytes(data):
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def crc32c(data) -> int:
    """CRC-32C of a bytes-like object. Large inputs are cut into a power of
    two of equal chunks whose registers advance side by side, then merged
    pairwise (a register ``a`` before chunk ``b`` of ``n`` bytes becomes
    ``Z_n(a) ^ b``, ``Z_n`` the linear map of ``n`` zero bytes)."""
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    if buf.size < 4096:
        return _crc_update(0xFFFFFFFF, buf) ^ 0xFFFFFFFF
    lanes = 1 << min(16, (buf.size // 64).bit_length() - 1)
    length = buf.size // lanes
    rows = np.ascontiguousarray(buf[:lanes * length].reshape(lanes, length).T)
    table = _crc_table()
    regs = np.zeros(lanes, np.uint32)
    regs[0] = 0xFFFFFFFF
    for row in rows:
        regs = table[(regs ^ row) & np.uint32(0xFF)] ^ (regs >> np.uint32(8))
    op = _zeros_operator(length)
    while regs.size > 1:
        regs = _apply(op, regs[0::2]) ^ regs[1::2]
        op = _apply(op, op)
    return _crc_update(int(regs[0]), buf[lanes * length:]) ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """LevelDB's masked form of a CRC, as stored in tables and bundles."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def parse_proto(buf: bytes) -> dict[int, list]:
    """A protobuf message's fields: number -> values in order (ints for
    varint and fixed fields, bytes for length-delimited ones)."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        fields.setdefault(number, []).append(value)
    return fields


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _block_entries(block: bytes):
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        n, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + n]
        pos += n


def _read_block(data: bytes, handle: bytes) -> bytes:
    offset, pos = _varint(handle, 0)
    size, _ = _varint(handle, pos)
    if offset + size + BLOCK_TRAILER_BYTES > len(data):
        raise ValueError("block past the end of the index file")
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"compressed index block (type {kind}): only uncompressed bundles "
                         "are read")
    (masked,) = struct.unpack_from("<I", data, offset + size + 1)
    if unmask_crc(masked) != crc32c(data[offset:offset + size + 1]):
        raise ValueError(f"index block at {offset}: checksum mismatch")
    return data[offset:offset + size]


class Entry(NamedTuple):
    dtype: int
    shape: tuple[int, ...]
    shard: int
    offset: int
    size: int
    crc32c: int
    n_slices: int


def _entry(value: bytes) -> Entry:
    f = parse_proto(value)
    dims = parse_proto(f[2][0]).get(2, []) if 2 in f else []
    shape = tuple(_int64(parse_proto(d).get(1, [0])[0]) for d in dims)
    one = lambda k: f.get(k, [0])[0]  # noqa: E731 - proto3 defaults are 0
    return Entry(one(1), shape, one(3), _int64(one(4)), _int64(one(5)), one(6),
                 len(f.get(7, [])))


class TFBundle:
    """The tensors of the bundle ``prefix`` (the path without ``.index``)."""

    def __init__(self, prefix: str | Path):
        self.prefix = str(prefix)
        data = Path(self.prefix + ".index").read_bytes()
        if len(data) < FOOTER_BYTES:
            raise ValueError(f"{self.prefix}.index is too short for a table")
        footer = data[-FOOTER_BYTES:]
        if struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0] != TABLE_MAGIC:
            raise ValueError(f"{self.prefix}.index is not a LevelDB table (bad magic)")
        _, pos = _varint(footer, 0)  # the metaindex block: bundles keep nothing there
        _, pos = _varint(footer, pos)
        entries = {}
        for _, handle in _block_entries(_read_block(data, footer[pos:])):
            entries.update(_block_entries(_read_block(data, handle)))
        if b"" not in entries:
            raise ValueError(f"{self.prefix}.index has no bundle header")
        header = parse_proto(entries.pop(b""))
        if header.get(2, [0])[0] != 0:
            raise ValueError(f"{self.prefix}: a big-endian bundle; only little-endian ones "
                             "are read")
        self.num_shards = header.get(1, [1])[0]
        self.entries = {k.decode(): _entry(v) for k, v in entries.items()
                        if not k.startswith(b"\x00")}  # b"\x00...": a slice of a partition

    def shapes(self) -> dict[str, tuple[int, ...]]:
        """Every tensor's name and shape, as ``get_variable_to_shape_map``."""
        return {name: e.shape for name, e in self.entries.items()}

    def tensor(self, name: str) -> np.ndarray:
        """The tensor ``name``, checked against its crc32c."""
        e = self.entries[name]
        if e.n_slices:
            raise ValueError(f"{name} is a partitioned variable ({e.n_slices} slices): not read")
        if e.dtype == DT_STRING:
            raise ValueError(f"{name} is a string tensor: not read")
        if e.dtype not in NUMPY_DTYPES:
            raise ValueError(f"{name} has TensorFlow dtype {e.dtype}, which is not read")
        dtype = np.dtype(NUMPY_DTYPES[e.dtype])
        if e.size != dtype.itemsize * int(np.prod(e.shape, dtype=np.int64)):
            raise ValueError(f"{name}: {e.size} bytes for shape {e.shape}")
        shard = f"{self.prefix}.data-{e.shard:05d}-of-{self.num_shards:05d}"
        with open(shard, "rb") as f:
            f.seek(e.offset)
            raw = f.read(e.size)
        if len(raw) != e.size:
            raise ValueError(f"{name}: {shard} ends before the tensor's {e.size} bytes")
        if crc32c(raw) != unmask_crc(e.crc32c):
            raise ValueError(f"{name}: checksum mismatch in {shard}")
        arr = np.frombuffer(raw, dtype).reshape(e.shape)
        if e.dtype == DT_BFLOAT16:
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(dtype.newbyteorder("="))
