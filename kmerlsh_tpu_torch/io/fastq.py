# Copy of kmerlsh_tpu/io/fastq.py; only its imports of this package changed.
"""Streaming FASTQ/FASTA reader and FASTQ writer (host side).

Replaces the reference's kseq/zlib ``FastqFile`` (utils/fastq.{h,cc}).
Supports plain and gzip files (sniffed by magic bytes), FASTQ (multi-record)
and FASTA (multi-line sequences). Like kseq, the record name is the first
whitespace-delimited token of the header (the comment is dropped — which is
also what the reference's extracted-read output does, io/ioFastQ.cc:122-125).
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass
from typing import Iterable, Iterator

try:  # optional C++ accelerator (native/_native.cc)
    import _kmerlsh_native as _native
except ImportError:  # pragma: no cover
    _native = None

PART_SIZE = 1 << 16  # reads per part, = FastqFile::part_size (utils/fastq.h:36)


@dataclass
class Read:
    name: bytes
    seq: bytes
    qual: bytes  # empty for FASTA


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return _io.BufferedReader(f)


def read_records(path: str) -> Iterator[Read]:
    """Yield reads from one FASTQ/FASTA file."""
    with _open(path) as f:
        line = f.readline()
        while line:
            line = line.rstrip(b"\r\n")
            if not line:
                line = f.readline()
                continue
            if line.startswith(b"@"):
                name = line[1:].split()[0] if len(line) > 1 else b""
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                qual = f.readline().rstrip(b"\r\n")
                yield Read(name, seq, qual)
                line = f.readline()
            elif line.startswith(b">"):
                name = line[1:].split()[0] if len(line) > 1 else b""
                chunks = []
                line = f.readline()
                while line and not line.startswith(b">") and not line.startswith(b"@"):
                    chunks.append(line.rstrip(b"\r\n"))
                    line = f.readline()
                yield Read(name, b"".join(chunks), b"")
            else:
                raise ValueError(f"{path}: unrecognized record header: {line[:60]!r}")


def _native_parts(path: str, part_size: int) -> Iterator[list[Read]]:
    import numpy as np

    rd = _native.FastqReader(path)
    while True:
        n, names, noff, seqs, soff, quals, qoff = rd.next_part(part_size)
        if n == 0:
            return
        no = np.frombuffer(noff, dtype="<i8")
        so = np.frombuffer(soff, dtype="<i8")
        qo = np.frombuffer(qoff, dtype="<i8")
        yield [
            Read(names[no[i]: no[i + 1]], seqs[so[i]: so[i + 1]],
                 quals[qo[i]: qo[i + 1]])
            for i in range(n)
        ]
        if n < part_size:
            return


def read_parts(
    paths: Iterable[str], part_size: int = PART_SIZE
) -> Iterator[list[Read]]:
    """Yield lists of up to ``part_size`` reads across the given files,
    matching the reference's 2^16-read part streaming (io/ioFastQ.cc:96).
    Uses the C++ streaming parser when built; pure-Python fallback
    otherwise."""
    part: list[Read] = []
    for p in paths:
        source = (
            (r for pt in _native_parts(p, part_size) for r in pt)
            if _native is not None else read_records(p)
        )
        for r in source:
            part.append(r)
            if len(part) >= part_size:
                yield part
                part = []
    if part:
        yield part


def write_fastq(f, reads: Iterable[Read]) -> None:
    """Write reads in the reference's extracted format:
    ``@name\\nseq\\n+\\nqual\\n`` (io/ioFastQ.cc:122-136)."""
    buf = bytearray()
    for r in reads:
        buf += b"@" + r.name + b"\n" + r.seq + b"\n+\n" + r.qual + b"\n"
        if len(buf) > 1 << 20:
            f.write(buf)
            buf = bytearray()
    if buf:
        f.write(buf)
