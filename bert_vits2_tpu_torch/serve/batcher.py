"""Dynamic micro-batching for TTS serving.

The reference serves /voice by looping infer() per segment on the GPU
(hiyoriUI.py:320-339) — batch 1 per device call. On the card that leaves it
idle between a call's small launches: a batch shares them across its riders.
This module batches at serve time: host preprocessing (g2p + BERT) runs on
the caller's thread, the prepared requests are queued, and one worker thread
drains them into `TTSEngine.run_prepared` calls — grouping requests that
share a text bucket, taking up to `max_batch` per call and waiting at most
`max_delay_s` for co-riders. A single client's auto-split paragraph and
concurrent HTTP clients both fill the same batch.
"""

from __future__ import annotations

import threading
import time


class _Pending:
    __slots__ = ("req", "key", "enqueued", "done", "wave", "error")

    def __init__(self, req, key):
        self.req = req
        self.key = key  # engine.group_key: (text bucket, emo kind)
        self.enqueued = time.monotonic()
        self.done = threading.Event()
        self.wave = None
        self.error: BaseException | None = None


class MicroBatcher:
    """Groups concurrent PreparedRequests into batched engine calls.

    Requests are grouped by the engine's `group_key` (text-length bucket +
    emotion-input kind) so a short utterance is never padded out to a long
    one's shape and incompatible graphs never share a call; a group is flushed
    when it reaches `max_batch` or its oldest member has waited
    `max_delay_s`. Each batched call draws noise from the first rider's
    seed, so per-request noise depends on batch composition — acceptable
    for serving (the reference draws fresh noise per call too).
    """

    def __init__(self, engine, max_batch: int = 16, max_delay_s: float = 0.01):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self._cv = threading.Condition()
        self._queue: list[_Pending] = []
        self._closed = False
        self.batch_sizes: list[int] = []  # observability: size of each call
        self._worker = threading.Thread(
            target=self._loop, name="tts-microbatcher", daemon=True
        )
        self._worker.start()

    # ---- client side ----

    def synthesize(self, *args, **kwargs):
        """prepare + submit one utterance -> waveform. Args as
        TTSEngine.prepare (text/segments, speaker, knobs, style, emotion)."""
        req = self.engine.prepare(*args, **kwargs)
        return self.submit([req])[0]

    def submit(self, reqs) -> list:
        """Enqueue prepared requests and block until all waves are ready.

        Requests may land in different device batches (different buckets /
        flush windows); results come back in request order regardless.
        """
        pendings = [_Pending(r, self.engine.group_key(r)) for r in reqs]
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.extend(pendings)
            self._cv.notify_all()
        waves = []
        for p in pendings:
            p.done.wait()
            if p.error is not None:
                raise p.error
            waves.append(p.wave)
        return waves

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join()

    # ---- worker side ----

    def _take_group(self) -> list[_Pending]:
        """Blocks until a group is ready to flush; [] means shut down."""
        with self._cv:
            while not self._queue:
                if self._closed:
                    return []
                self._cv.wait()
            head = self._queue[0]
            deadline = head.enqueued + self.max_delay_s
            while True:
                same = [p for p in self._queue if p.key == head.key]
                remaining = deadline - time.monotonic()
                if len(same) >= self.max_batch or remaining <= 0 or self._closed:
                    # burst packing: when more than one call's worth is
                    # queued, co-batch similar text lengths so the flush's
                    # duration-predicted frame cap stays tight (the
                    # leftovers flush immediately next loop — their
                    # deadline has already passed)
                    if len(same) > self.max_batch:
                        same.sort(key=lambda p: len(p.req.inputs[0]),
                                  reverse=True)
                    group = same[: self.max_batch]
                    taken = set(map(id, group))
                    self._queue = [
                        p for p in self._queue if id(p) not in taken
                    ]
                    return group
                self._cv.wait(timeout=remaining)

    def _loop(self):
        while True:
            group = self._take_group()
            if not group:
                return
            try:
                waves = self.engine.run_prepared([p.req for p in group])
            except BaseException as e:  # noqa: BLE001 - delivered to waiters
                for p in group:
                    p.error = e
                    p.done.set()
            else:
                self.batch_sizes.append(len(group))
                for p, w in zip(group, waves):
                    p.wave = w
                    p.done.set()
