"""Worker-pool data loader — the port's copy of pytorchocr_tpu/data/loader.py
(OCRDataLoader at :83, default_collate), torch-free: it yields collated numpy
batches and the trainer moves them to the card.

* workers run the cv2/numpy op chain concurrently, with a bounded prefetch
  window so host preprocessing overlaps the device step. Two worker modes:
  - ``thread`` (default): zero-copy handoff; the ops draw from the
    process-wide `random` / `np.random` in the order the threads reach them
    (one worker: the sample order);
  - ``process``: fork-based worker processes for GT-maker-heavy pipelines
    whose Python cost serializes on the GIL. Each batch task reseeds
    `random` / `np.random` from (seed, epoch, batch) (`task_seed`, :160), so
    augmentations are reproducible.
* the epoch order is `RandomState(seed + epoch)` (:120-125), then the
  per-rank shard (`shard_index` / `num_shards`);
* `set_epoch` folds in the torch `sampler.set_epoch` contract.

A torch DataLoader is not used: its workers seed and order differently, and
the JAX loader's batches are the reference.
"""

import multiprocessing
import queue
import random as _pyrandom
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

# Per-worker state (process mode), installed by the pool initializer at
# worker start. Fork is safe here because workers only run numpy/cv2: they
# never touch CUDA, whose context a forked child cannot use.
_WORKER_DATASET = None
_WORKER_COLLATE = None


def _proc_init(dataset, collate_fn):
    global _WORKER_DATASET, _WORKER_COLLATE
    _WORKER_DATASET = dataset
    _WORKER_COLLATE = collate_fn
    # cv2's internal thread pool does not survive fork; pin to 1 thread in
    # the child (same mitigation torch DataLoader documents).
    try:
        import cv2

        cv2.setNumThreads(0)
    except Exception:
        pass


def _proc_load_batch(chunk, task_seed):
    _pyrandom.seed(task_seed)
    np.random.seed(task_seed % (2**32))
    samples = [_WORKER_DATASET[int(i)] for i in chunk]
    return _WORKER_COLLATE(samples)


def default_collate(samples):
    """Stack positional fields across samples (the KeepKeys list contract)."""
    num_fields = len(samples[0])
    batch = []
    for i in range(num_fields):
        fields = [s[i] for s in samples]
        first = fields[0]
        if isinstance(first, np.ndarray):
            try:
                batch.append(np.stack(fields, axis=0))
            except ValueError:
                batch.append(fields)  # ragged (e.g. polys at eval bs>1)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            batch.append(np.asarray(fields))
        else:
            batch.append(fields)
    return batch


class OCRDataLoader:
    """Iterable over collated numpy batches with background workers."""

    def __init__(
        self,
        dataset,
        batch_size,
        shuffle=False,
        drop_last=False,
        num_workers=4,
        seed=None,
        shard_index=0,
        num_shards=1,
        collate_fn=None,
        prefetch_factor=4,
        worker_mode="thread",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.seed = 0 if seed is None else int(seed)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.collate_fn = collate_fn or default_collate
        self.prefetch_factor = prefetch_factor
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, got {worker_mode}")
        if worker_mode == "process" and "fork" not in multiprocessing.get_all_start_methods():
            worker_mode = "thread"  # no fork on this platform (e.g. Windows)
        self.worker_mode = worker_mode
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = int(epoch)

    def _epoch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        if self.num_shards > 1:
            # pad so every shard sees the same number of samples (mirrors
            # torch DistributedSampler's wrap-around)
            per_shard = -(-n // self.num_shards)
            padded = np.concatenate([order, order[: per_shard * self.num_shards - n]])
            order = padded[self.shard_index :: self.num_shards]
        return order

    def __len__(self):
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        indices = self._epoch_indices()
        n = len(indices)
        batches = []
        for start in range(0, n, self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            batches.append(chunk)

        out_q = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()
        use_proc = self.worker_mode == "process" and self.num_workers > 1
        # In process mode one worker owns one whole batch, so parallelism is
        # bounded by the in-flight window — widen it to keep all workers busy.
        window = max(self.prefetch_factor, self.num_workers if use_proc else 0)
        epoch = self._epoch

        def submit(pool, batch_idx, chunk):
            if use_proc:
                task_seed = (self.seed * 1_000_003 + epoch) * 7_368_787 + batch_idx
                return pool.submit(_proc_load_batch, chunk, task_seed & 0x7FFFFFFF)
            return pool.submit(self._load_batch, chunk)

        def _put_or_abandon(item):
            """Blocking put that gives up once the consumer has left."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            pool = None
            try:
                if use_proc:
                    pool = ProcessPoolExecutor(
                        max_workers=self.num_workers,
                        mp_context=multiprocessing.get_context("fork"),
                        initializer=_proc_init,
                        initargs=(self.dataset, self.collate_fn),
                    )
                else:
                    pool = ThreadPoolExecutor(max_workers=self.num_workers)
                futures = []
                for batch_idx, chunk in enumerate(batches):
                    if stop.is_set():
                        break
                    futures.append(submit(pool, batch_idx, chunk))
                    # drain completed futures in order, keep window bounded
                    while len(futures) >= window:
                        f = futures.pop(0)
                        if self._emit(out_q, stop, f):
                            return
                for f in futures:
                    if self._emit(out_q, stop, f):
                        return
            except BaseException as e:  # noqa: BLE001 — pool creation or
                # submit() itself can raise (e.g. BrokenProcessPool after a
                # worker was OOM-killed); without forwarding, the exception
                # would die with this thread and the consumer would block on
                # out_q.get() forever.
                _put_or_abandon(e)
            finally:
                if pool is not None:
                    # cancel_futures: don't force a full drain when the
                    # consumer abandoned the epoch early (KeyboardInterrupt,
                    # eval gating).
                    pool.shutdown(wait=False, cancel_futures=True)
                _put_or_abandon(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock the producer if it is waiting on a full queue
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass

    @staticmethod
    def _emit(out_q, stop, future):
        """Put a finished batch on the queue; returns True if consumer left."""
        try:
            result = future.result()
        except Exception as e:  # surface worker errors to the consumer
            result = e
        while not stop.is_set():
            try:
                out_q.put(result, timeout=0.5)
                return False
            except queue.Full:
                continue
        return True

    def _load_batch(self, chunk):
        samples = [self.dataset[int(i)] for i in chunk]
        return self.collate_fn(samples)
