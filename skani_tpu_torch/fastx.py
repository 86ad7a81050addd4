"""FASTA/FASTQ reading (plain or gzip).

Mirrors the behavior of the reference's needletail-based reader
(reference: src/file_io.rs:141-252): contig id is the full header line
(after '>'/'@', up to but excluding the first newline), sequence is the raw
byte string with line breaks removed.
"""
from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Tuple

import numpy as np


class InvalidFastxError(Exception):
    pass


def _open_maybe_gzip(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


def read_fastx(path: str) -> bytes:
    """A fasta/fastq file's bytes (gunzipped); InvalidFastxError for a
    missing or empty file."""
    if not os.path.isfile(path):
        raise InvalidFastxError(f"{path} does not exist")
    with _open_maybe_gzip(path) as f:
        data = f.read()
    if not data:
        raise InvalidFastxError(f"{path} is empty")
    return data


def iter_fastx(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (contig_id, sequence bytes as uint8 array) records.

    Raises InvalidFastxError for files that are not fasta/fastq, matching the
    reference's warn-and-skip behavior at a higher level.
    """
    yield from iter_fastx_bytes(read_fastx(path), path)


def iter_fastx_bytes(data: bytes,
                     path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """iter_fastx over a file's bytes (read_fastx)."""
    first = data[:1]
    if first == b">":
        yield from _iter_fasta(data)
    elif first == b"@":
        yield from _iter_fastq(data, path)
    else:
        raise InvalidFastxError(f"{path} is not a valid fasta/fastq file")


def _iter_fasta(data: bytes) -> Iterator[Tuple[str, np.ndarray]]:
    # Split on record starts. data[0] == '>'.
    pos = 0
    n = len(data)
    while pos < n:
        assert data[pos:pos + 1] == b">"
        eol = data.find(b"\n", pos)
        if eol == -1:
            header = data[pos + 1:]
            seq_block = b""
            pos = n
        else:
            header = data[pos + 1:eol]
            nxt = data.find(b"\n>", eol)
            if nxt == -1:
                seq_block = data[eol + 1:]
                pos = n
            else:
                seq_block = data[eol + 1:nxt + 1]
                pos = nxt + 1
        header = header.rstrip(b"\r")
        seq = seq_block.replace(b"\n", b"").replace(b"\r", b"")
        yield header.decode("utf-8", "replace"), np.frombuffer(seq, dtype=np.uint8)


def _iter_fastq(data: bytes, path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """FASTQ records, including (legal, rare) multi-line sequence and
    quality blocks: sequence lines accumulate until the '+' separator,
    then quality lines until their length catches up (the needletail
    behavior the reference inherits)."""
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i < n:
        if not lines[i]:
            i += 1
            continue
        if lines[i][:1] != b"@" or i + 3 >= n:
            raise InvalidFastxError(f"{path} is not a valid fastq file")
        header = lines[i][1:].rstrip(b"\r")
        i += 1
        seq_parts = []
        while i < n and lines[i][:1] != b"+":
            seq_parts.append(lines[i].rstrip(b"\r"))
            i += 1
        if i >= n:
            raise InvalidFastxError(f"{path} is not a valid fastq file")
        seq = b"".join(seq_parts)
        i += 1   # skip the '+' separator
        qlen = 0
        while i < n and qlen < len(seq):
            qline = lines[i].rstrip(b"\r")
            if not qline:
                # a blank quality line can never catch up to the sequence
                # length; without this guard the catch-up loop would swallow
                # the next '@' header as quality and silently desync records
                raise InvalidFastxError(
                    f"{path} is not a valid fastq file")
            qlen += len(qline)
            i += 1
        yield header.decode("utf-8", "replace"), \
            np.frombuffer(seq, dtype=np.uint8)
