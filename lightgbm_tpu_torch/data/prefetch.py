"""Block prefetch: disk -> pinned host ring -> device ring (port of
lightgbm_tpu/data/prefetch.py :31-210, rebuilt for the card).

The pipeline the out-of-core learner drives for every histogram pass
(data/ooc_learner.py): a reader thread reads the next blocks from the
store's files into a ring of `depth` pinned host buffers and issues
each one's host -> device copy on a copy stream of its own, into a ring
of `depth + 1` device buffers, while the compute stream folds the
previous block into the histogram carry.

Two hazards bound the rings, both held by CUDA events (the JAX
package's CPU pipeline met the same one as nondeterministic trees,
prefetch.py:135-143):
- a pinned buffer is refilled only after the copy that read it has run
  (the reader thread waits on that copy's event);
- a device buffer is overwritten only after the folds that read it have
  run: when the consumer moves past a block, an event recorded on the
  compute stream hands the buffer back, and the copy stream waits on it
  before its next copy into that buffer.
The consumer makes the compute stream wait on a block's copy event
before it reads the block. On the CPU, staging is a plain copy.

Resident bin memory is bounded: the pinned ring, the device ring, an
optional LRU of `cache_blocks` device blocks and one shared zero block
per padding width. `stats()` gives the counters: consumer wait seconds,
producer busy (read + stage) seconds, pass wall seconds (reported by the
consumer), bytes read, cache hits and the overlap percentage.
"""

import queue
import threading
import time

import numpy as np
import torch

from ..utils import faults

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int16): torch.int16}


class BlockPrefetcher:
    """Streams a fixed span plan (the learner's block geometry) again
    and again: one `stream()` call per histogram pass."""

    def __init__(self, store, spans, depth=2, cache_blocks=0, device=None):
        self.store = store
        # spans: (block_idx, span_rows, data_rows); block_idx None for an
        # all-zero padding span past the data
        self.spans = list(spans)
        self.depth = max(1, int(depth))
        self.cache_blocks = max(0, int(cache_blocks))
        self.device = torch.device("cpu") if device is None else device
        self._cuda = self.device.type == "cuda"
        self._dtype = _TORCH_DTYPE[np.dtype(store.dtype)]
        item = store.num_stored * store.block_rows
        # each ring entry: (buffer, event of the last work that used it)
        self._free_host = queue.Queue()
        for _ in range(self.depth):
            buf = torch.empty(item, dtype=self._dtype,
                              pin_memory=self._cuda)
            self._free_host.put((buf, None))
        self._free_dev = queue.Queue()
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device=self.device)
            for _ in range(self.depth + 1):
                self._free_dev.put((torch.empty(item, dtype=self._dtype,
                                                device=self.device), None))
        self._cache = {}        # span index -> (device block, ready event)
        self._cache_order = []
        self._zero = {}         # span width -> shared all-zero block
        self.wait_s = 0.0       # consumer blocked on the queue
        self.read_s = 0.0       # producer busy (disk copy + stage)
        self.wall_s = 0.0       # pass walls reported by the consumer
        self.bytes_read = 0
        self.blocks_read = 0
        self.cache_hits = 0
        self.passes = 0

    # ------------------------------------------------------------ helpers
    def _event(self, stream):
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def _zero_span(self, width):
        blk = self._zero.get(width)
        if blk is None:
            blk = torch.zeros((self.store.num_stored, width),
                              dtype=self._dtype, device=self.device)
            self._zero[width] = blk
        return blk

    def _cache_put(self, key, entry):
        if self.cache_blocks <= 0 or key in self._cache:
            return
        self._cache[key] = entry
        self._cache_order.append(key)
        while len(self._cache_order) > self.cache_blocks:
            self._cache.pop(self._cache_order.pop(0), None)

    def resident_bytes(self):
        """Upper bound of the bin bytes this pipeline keeps: the host
        ring, the device ring (on the card), the cache and the shared
        zero blocks."""
        item = (self.store.num_stored * self.store.block_rows
                * self.store.dtype.itemsize)
        rings = self.depth + (self.depth + 1 if self._cuda else 0)
        return item * (rings + len(self._cache) + len(self._zero))

    def _stage(self, key, bidx, span_rows, data_rows):
        """Read block `bidx` into a host buffer, zero its padding and
        stage it: a (view, ready event, device buffer entry or None)
        triple."""
        buf, copied = self._free_host.get()
        if copied is not None:
            copied.synchronize()   # the last copy out of this buffer ran
        t0 = time.perf_counter()
        f = self.store.num_stored
        host = buf[:f * span_rows].view(f, span_rows)
        rows = self.store.read_block_into(bidx, host.numpy())
        if rows != data_rows:
            self._free_host.put((buf, None))
            raise RuntimeError(f"block {bidx} holds {rows} rows, span plan "
                               f"expects {data_rows}")
        if span_rows > rows:
            host[:, rows:] = 0
        faults.rank_crash_in_prefetch_if_reached()
        if not self._cuda:
            staged = (host.clone(), None, None)
            self._free_host.put((buf, None))
        else:
            dev_entry = None
            if self.cache_blocks <= 0:
                dev_entry = self._free_dev.get()
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._copy_stream):
                if dev_entry is None:
                    # a block of its own (the cache may keep it),
                    # allocated on the copy stream; the consumer marks
                    # its use on the compute stream (record_stream)
                    dst = torch.empty((f, span_rows), dtype=self._dtype,
                                      device=self.device)
                else:
                    dst = dev_entry[0][:f * span_rows].view(f, span_rows)
                if dev_entry is not None and dev_entry[1] is not None:
                    # the folds that read this device buffer ran first
                    self._copy_stream.wait_event(dev_entry[1])
                dst.copy_(host, non_blocking=True)
                ready = self._event(self._copy_stream)
            self._free_host.put((buf, ready))
            staged = (dst, ready, dev_entry)
        self.read_s += time.perf_counter() - t0
        self.bytes_read += rows * f * self.store.dtype.itemsize
        self.blocks_read += 1
        if self.cache_blocks > 0:
            self._cache_put(key, staged[:2])
        return staged

    # ------------------------------------------------------------- stream
    def stream(self):
        """Yield (row_start, row_end, block) per span, in order: `block`
        is (num_stored, row_end - row_start) on the device, rows past the
        data zero, and the current stream already waits for its copy.
        Work the consumer queues on the current stream before asking for
        the next block may read it."""
        self.passes += 1
        q = queue.Queue(maxsize=self.depth)
        end = object()
        err = []

        def produce():
            try:
                row = 0
                for key, (bidx, span_rows, data_rows) in \
                        enumerate(self.spans):
                    cached = self._cache.get(key)
                    if cached is not None:
                        self.cache_hits += 1
                        item = (cached[0], cached[1], None)
                    elif bidx is None or data_rows == 0:
                        item = (self._zero_span(span_rows), None, None)
                    else:
                        item = self._stage(key, bidx, span_rows, data_rows)
                    q.put((row, row + span_rows) + item)
                    row += span_rows
            except BaseException as e:
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=produce, daemon=True,
                             name="ooc-block-prefetch")
        t.start()
        compute = torch.cuda.current_stream(self.device) if self._cuda \
            else None
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is end:
                    break
                s, e, blk, ready, dev_entry = item
                if ready is not None:
                    compute.wait_event(ready)
                    if dev_entry is None:
                        blk.record_stream(compute)
                yield s, e, blk
                if dev_entry is not None:
                    # the consumer queued its folds of blk: the buffer
                    # goes back once they have run
                    self._free_dev.put((dev_entry[0], self._event(compute)))
        finally:
            # an early consumer exit: drain so the producer can finish,
            # handing back the device buffers it staged
            while t.is_alive() or not q.empty():
                try:
                    item = q.get(timeout=0.001)
                except queue.Empty:
                    continue
                if item is not end and item[4] is not None:
                    self._free_dev.put((item[4][0], None))
            t.join(timeout=10)
        if err:
            raise err[0]

    # -------------------------------------------------------------- stats
    def note_pass_wall(self, seconds):
        """Consumer hook: the wall seconds of one histogram pass, its
        device work included (data/ooc_learner.py waits for the pass's
        last fold)."""
        self.wall_s += float(seconds)

    def overlap_pct(self):
        """Share of the pass wall time not spent waiting on the prefetch
        queue: 100 when the reads were hidden behind the folds, 0 when
        every second was a read stall. The producer's busy time is the
        denominator until a consumer reports pass walls."""
        denom = self.wall_s if self.wall_s > 0.0 else self.read_s
        if denom <= 0.0:
            return 100.0
        return max(0.0, min(100.0, 100.0 * (1.0 - self.wait_s / denom)))

    def stats(self):
        return {
            "prefetch_wait_s": round(self.wait_s, 6),
            "prefetch_read_s": round(self.read_s, 6),
            "prefetch_wall_s": round(self.wall_s, 6),
            "prefetch_bytes": int(self.bytes_read),
            "prefetch_blocks": int(self.blocks_read),
            "prefetch_cache_hits": int(self.cache_hits),
            "prefetch_overlap_pct": round(self.overlap_pct(), 2),
        }
