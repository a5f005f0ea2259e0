"""Minimal TensorBoard event-file writer (pure Python, no deps; own copy of
clg_vqa_tpu/utils/tb_events.py).

The reference's tbLogger emits tensorboard scalars via tensorboardX
(volta/volta/train_utils.py:28, 73-75). This module restores
that output contract without pulling in tensorflow/tensorboardX: it
hand-serializes `Event{wall_time, step, summary{value{tag, simple_value}}}`
protobufs and frames them as TFRecords (length + masked-CRC32C framing), the
exact on-disk format `tensorboard --logdir` reads.

Wire format references: tensorflow/core/util/event.proto (Event fields:
1=wall_time double, 2=step int64, 3=file_version string, 5=summary),
tensorflow/core/framework/summary.proto (Summary: repeated Value=1;
Value: 1=tag string, 2=simple_value float), and the TFRecord framing
(uint64 len, crc(len), payload, crc(payload), each CRC masked).
"""
from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:       # Python's >> never zeroes a negative — would hang
        raise ValueError(f"varint requires a non-negative int, got {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    ev = _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        ev += _field(2, 0) + _varint(step)
    if file_version is not None:
        ev += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, val in scalars.items():
            value = (_bytes_field(1, tag.encode())
                     + _field(2, 5) + struct.pack("<f", float(val)))
            summary += _bytes_field(1, value)
        ev += _bytes_field(5, summary)
    return ev


def _record(payload: bytes) -> bytes:
    hdr = struct.pack("<Q", len(payload))
    return (hdr + struct.pack("<I", _masked_crc(hdr)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Append-only scalar event writer; one file per run directory."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        self._f.write(_record(_event(time.time(), step=step,
                                     scalars=scalars)))
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()
