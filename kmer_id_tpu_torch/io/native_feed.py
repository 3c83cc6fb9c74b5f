"""Batch feeder over the native decoder: C++ fills [B, L] planes directly.

Produces the same Batch/LongRead stream as io/batch.py's Python path (tests
assert equality), but decode/trim/encode run in native code and accession/
trimmed-sequence text stays in bulk blobs, materialized as Python strings
only for the rare rows the saved-read capture actually touches.

Rows whose trimmed read exceeds max_len are *placeholders*: their in-plane
codes are truncated, so the feeder zeroes them out of the device batch and
reports them in ``long_rows`` — the engine classifies them via the chunked
long-read path at exactly their position in read order (order matters for
the first-SAVENUM capture semantics, newkmer_10nx.cpp:608-613).

Started as a copy of ``kmer_id_tpu/io/native_feed.py``.  Where it differs:
the fill writes each batch's packed words and exception list beside its code
plane (io/native), so emitting a batch no longer calls
``io/batch.py:pack_codes``; the batches are byte-identical to the JAX
package's feeder's (tests/test_torch_host.py).  The native reader inflates
each file on a worker thread ahead of the fill (io/native).  It also keeps
batch ids and a trace (below).

A feeder decodes one stream: a plain caller feeds it file after file, and a
file's last batch is topped up by the next file's first reads.  The sample
loop (engine/pipeline.py) gives each file of a request a feeder of its own on
a thread of its own, the files' feeders sharing one counter of batch ids.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from kmer_id_tpu_torch.io.batch import EXC_CAP, Batch, RowMeta
from kmer_id_tpu_torch.io.native import NativeFileReader, detect_format, get_lib
from kmer_id_tpu_torch.core.codec import CODE_LUT, CODE_LUT_U, INVALID
from kmer_id_tpu_torch.utils import timing


def native_available() -> bool:
    return get_lib() is not None


class BlobMetas:
    """Lazy per-row RowMeta views over the copied text blobs."""

    def __init__(self, acc_bytes, acc_off, seq_bytes, seq_off, n_rows):
        self.acc_bytes = acc_bytes
        self.acc_off = acc_off
        self.seq_bytes = seq_bytes
        self.seq_off = seq_off
        self.n_rows = n_rows

    def __getitem__(self, i: int) -> Optional[RowMeta]:
        if i >= self.n_rows:
            return None
        acc = bytes(self.acc_bytes[self.acc_off[i] : self.acc_off[i + 1]]).decode(
            "latin-1"
        )
        seq = bytes(self.seq_bytes[self.seq_off[i] : self.seq_off[i + 1]]).decode(
            "latin-1"
        )
        return RowMeta(acc=acc, trimmed_seq=seq)

    def seq_codes(self, i: int, u_is_t: bool) -> np.ndarray:
        lut = CODE_LUT_U if u_is_t else CODE_LUT
        raw = self.seq_bytes[self.seq_off[i] : self.seq_off[i + 1]]
        return lut[raw]


@dataclass
class NativeBatch:
    batch: Batch
    long_rows: list[int]  # row indices whose true read exceeds max_len
    bid: int = -1  # the batch's id: the feeder's emit order
    file: int = 0  # the index of the request's file it was read from


class NativePlaneFeeder:
    """Feeds read files through the native decoder into full planes.

    With a ``trace`` (utils/timing.py) each ``NativeFileReader.fill`` (which
    also packs the words) is a ``decode.fill`` span and each emitted batch's
    hand-off (blob copies, the batch, new planes) a ``decode.pack`` span,
    both under the id of the batch being filled; the counter ``pack.plane``
    counts the batches whose exceptions overflowed ``EXC_CAP``, which ship
    their u8 plane, and ``inflate.blocks``, ``inflate.waits`` and
    ``inflate.wait_us`` count the read-ahead blocks the fills took, how many
    of them they waited for, and the microseconds they waited.

    Each plane takes its batch id from ``ids`` as it is made: without one,
    from the feeder's own count, so that the ids are the emit order; a
    counter shared by feeders keeps their batches' ids unique."""

    def __init__(self, batch_size: int, max_len: int, u_is_t: bool,
                 acc_cap_per_row: int = 256, seq_cap_per_row: int = 1024, trace=None,
                 ids: Optional[Iterator[int]] = None):
        self.b = batch_size
        self.l = max_len
        self.u_is_t = u_is_t
        self.trace = trace
        self.emitted = 0  # batches emitted so far
        self._ids = itertools.count() if ids is None else ids
        self._new_plane()
        self.acc_cap = self.b * acc_cap_per_row
        self.seq_cap = self.b * seq_cap_per_row
        self.acc_buf = np.zeros(self.acc_cap, dtype=np.uint8)
        self.seq_buf = np.zeros(self.seq_cap, dtype=np.uint8)
        self.acc_off = np.zeros(self.b + 1, dtype=np.int64)
        self.seq_off = np.zeros(self.b + 1, dtype=np.int64)

    def _new_plane(self):
        # fresh arrays per batch: the submitter reads the emitted ones.  The
        # fill writes every byte of the rows it fills; _pack pads the rest.
        self.codes = np.empty((self.b, self.l), dtype=np.uint8)
        self.lengths = np.zeros(self.b, dtype=np.int32)
        self.packed = np.empty((self.b, (self.l + 15) // 16), dtype=np.uint32)
        self.exc = np.full(EXC_CAP, -1, dtype=np.int32)
        self.n_exc = np.zeros(1, dtype=np.int32)
        self.row = 0
        self.bid = next(self._ids)  # the id of the batch this plane becomes

    def _emit(self) -> NativeBatch:
        with timing.span(self.trace, "decode.pack", self.bid):
            nb = self._pack()
        self.emitted += 1
        return nb

    def _pack(self) -> NativeBatch:
        n, bid = self.row, self.bid
        self.codes[n:] = INVALID  # padding rows: pad codes, packed as zeros
        self.packed[n:] = 0
        metas = BlobMetas(
            self.acc_buf[: self.acc_off[n]].copy(),
            self.acc_off[: n + 1].copy(),
            self.seq_buf[: self.seq_off[n]].copy(),
            self.seq_off[: n + 1].copy(),
            n,
        )
        long_rows = np.nonzero(self.lengths[:n] > self.l)[0].tolist()
        # long placeholder rows are zeroed out of the device batch (their
        # in-plane codes are truncated junk; the fill gave them no exceptions)
        lens_dev = self.lengths.copy()
        if long_rows:
            lens_dev[long_rows] = 0
        overflow = int(self.n_exc[0]) > EXC_CAP
        timing.count(self.trace, "pack.plane", int(overflow))
        packed, exc = (None, None) if overflow else (self.packed, self.exc)
        batch = Batch(codes=self.codes, lengths=lens_dev, metas=metas, n_rows=n,
                      packed=packed, exc=exc)
        self._new_plane()
        self.acc_off[0] = 0
        self.seq_off[0] = 0
        return NativeBatch(batch=batch, long_rows=long_rows, bid=bid)

    def feed_path(self, path: str, fmt: str | None = None) -> Iterator[NativeBatch]:
        fmt = fmt or detect_format(path)
        if fmt is None:
            return
        yield from self.feed_reader(NativeFileReader(path, fmt, self.u_is_t))

    def feed_reader(self, reader: NativeFileReader) -> Iterator[NativeBatch]:
        """The full batches of an open reader's file, which it closes at
        the end; the last rows stay in the plane for the next file or
        :meth:`flush`."""
        try:
            while True:
                with timing.span(self.trace, "decode.fill", self.bid):
                    filled, eof, (blocks, waits, wait_ns) = reader.fill(
                        self.row, self.codes, self.lengths,
                        self.packed, self.exc, self.n_exc,
                        self.acc_buf, self.acc_off, self.seq_buf, self.seq_off,
                    )
                timing.count(self.trace, "inflate.blocks", blocks)
                timing.count(self.trace, "inflate.waits", waits)
                timing.count(self.trace, "inflate.wait_us", (wait_ns + 500) // 1000)
                self.row += filled
                if self.row >= self.b:
                    yield self._emit()
                elif eof:
                    break
                elif filled == 0 and self.row > 0:
                    # text blobs full before the plane: flush early
                    yield self._emit()
                elif filled == 0:
                    # one record larger than the blobs: grow and retry
                    self.seq_cap *= 2
                    self.acc_cap *= 2
                    self.seq_buf = np.zeros(self.seq_cap, dtype=np.uint8)
                    self.acc_buf = np.zeros(self.acc_cap, dtype=np.uint8)
        finally:
            reader.close()

    def flush(self) -> Iterator[NativeBatch]:
        if self.row > 0:
            yield self._emit()
