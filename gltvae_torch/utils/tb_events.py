"""TensorBoard event files, written and read with the standard library.

The port writes the scalar events that ``tf.summary.scalar`` writes under
TF2, without tensorflow or tensorboard (neither is a dependency of the
port). A file is a sequence of TFRecords:

    uint64 length (little-endian) | masked CRC32C of those 8 bytes |
    payload | masked CRC32C of the payload

where the mask is ``((c >> 15 | c << 17) + 0xa282ead8) mod 2**32``. Each
payload is an ``Event`` protobuf, encoded here by hand: ``wall_time`` (1,
double), ``step`` (2, int64), ``file_version`` (3, the first record's
``"brain.Event:2"``) and ``summary`` (5). A scalar is one event holding one
``Summary.Value``: ``tag`` (1), ``tensor`` (8: DT_FLOAT, an empty shape,
the value as 4 little-endian bytes in ``tensor_content``) and ``metadata``
(9: ``plugin_data.plugin_name = "scalars"``), the fields TF2 writes.

The reader parses only these fields and checks every CRC; the tests and
``chip_smoke.py`` read files back with it.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

FILE_VERSION = 'brain.Event:2'
_DT_FLOAT = 1


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
    """One TFRecord holding `payload`."""
    n = struct.pack('<Q', len(payload))
    return (n + struct.pack('<I', masked_crc(n)) + payload
            + struct.pack('<I', masked_crc(payload)))


# ------------------------------ protobuf ------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1               # int64: two's complement, 10 bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    out = b'\x09' + struct.pack('<d', wall_time)
    if step:                          # proto3 leaves a zero step out
        out += b'\x10' + _varint(step)
    return out + body


def scalar_event(tag: str, value: float, step: int,
                 wall_time: Optional[float] = None) -> bytes:
    """The Event payload ``tf.summary.scalar(tag, value, step)`` writes."""
    tensor = (b'\x08' + _varint(_DT_FLOAT) + _field(2, b'')
              + _field(4, struct.pack('<f', value)))
    metadata = _field(1, _field(1, b'scalars'))
    summary_value = (_field(1, tag.encode()) + _field(8, tensor)
                     + _field(9, metadata))
    return _event(time.time() if wall_time is None else wall_time, step,
                  _field(5, _field(1, summary_value)))


def version_event(wall_time: Optional[float] = None) -> bytes:
    """The first record of a file: its version and the writer's name."""
    return _event(time.time() if wall_time is None else wall_time, 0,
                  _field(3, FILE_VERSION.encode())
                  + _field(10, _field(1, b'gltvae_torch.utils.tb_events')))


class EventFileWriter:
    """Scalar events appended to one file in `logdir`, named as TF names
    its files: ``events.out.tfevents.<int time>.<host>.<pid>.0.v2``. The
    file is created, with its version record, by the first ``write``; each
    write opens, appends and closes it, so nothing stays open between
    writes."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None

    def write(self, step: int, scalars: Mapping[str, float]) -> None:
        """One event per tag, in tag order, all at `step`."""
        records = []
        if self.path is None:
            os.makedirs(self.logdir, exist_ok=True)
            now = time.time()
            self.path = os.path.join(
                self.logdir, f'events.out.tfevents.{int(now)}.'
                f'{socket.gethostname()}.{os.getpid()}.0.v2')
            records.append(frame(version_event(now)))
        records += [frame(scalar_event(tag, float(scalars[tag]), step))
                    for tag in sorted(scalars)]
        with open(self.path, 'ab') as f:
            f.write(b''.join(records))


# ------------------------------- reader -------------------------------

def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file; raises ValueError on a bad CRC or
    a truncated record."""
    with open(path, 'rb') as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f'{path}: truncated record header at {pos}')
        head = data[pos:pos + 8]
        (n,), (hc,) = struct.unpack('<Q', head), struct.unpack(
            '<I', data[pos + 8:pos + 12])
        if hc != masked_crc(head):
            raise ValueError(f'{path}: bad length CRC at {pos}')
        payload = data[pos + 12:pos + 12 + n]
        tail = data[pos + 12 + n:pos + 16 + n]
        if len(payload) != n or len(tail) != 4:
            raise ValueError(f'{path}: truncated record at {pos}')
        if struct.unpack('<I', tail)[0] != masked_crc(payload):
            raise ValueError(f'{path}: bad payload CRC at {pos}')
        yield payload
        pos += 16 + n


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a protobuf message: ints for varints,
    bytes for the other wire types."""
    pos = 0

    def varint():
        nonlocal pos
        shift = n = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    while pos < len(buf):
        key = varint()
        num, wire = key >> 3, key & 7
        if wire == 0:
            yield num, varint()
        elif wire == 1:
            yield num, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            n = varint()
            yield num, buf[pos:pos + n]
            pos += n
        elif wire == 5:
            yield num, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f'unsupported protobuf wire type {wire}')


def _scalar_value(value: bytes) -> Tuple[str, Optional[float]]:
    tag, val = '', None
    for num, v in _fields(value):
        if num == 1:
            tag = v.decode()
        elif num == 8:                            # tensor
            for tnum, tv in _fields(v):
                if tnum == 4 and len(tv) == 4:    # tensor_content
                    val = struct.unpack('<f', tv)[0]
    return tag, val


def read_events(path: str) -> List[Dict]:
    """Every event of a file as {'wall_time', 'step', 'file_version',
    'scalars': {tag: float}}."""
    events = []
    for payload in read_records(path):
        ev = {'wall_time': 0.0, 'step': 0, 'file_version': None,
              'scalars': {}}
        for num, v in _fields(payload):
            if num == 1:
                ev['wall_time'] = struct.unpack('<d', v)[0]
            elif num == 2:
                ev['step'] = v - (1 << 64) if v >= 1 << 63 else v
            elif num == 3:
                ev['file_version'] = v.decode()
            elif num == 5:
                for snum, sv in _fields(v):
                    if snum == 1:
                        tag, val = _scalar_value(sv)
                        if val is not None:
                            ev['scalars'][tag] = val
        events.append(ev)
    return events


def read_scalars(logdir: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} over every event file in `logdir`, in
    file-name then record order."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for name in sorted(os.listdir(logdir)):
        if 'tfevents' not in name:
            continue
        for ev in read_events(os.path.join(logdir, name)):
            for tag, val in ev['scalars'].items():
                out.setdefault(tag, []).append((ev['step'], val))
    return out
