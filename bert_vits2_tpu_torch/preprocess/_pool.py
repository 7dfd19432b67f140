"""The file-level parallel map of `resample` and `spec_gen`."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor


def map_jobs(fn, jobs: list, processes: int) -> list:
    """[fn(job) for job in jobs] in `processes` worker processes, as the
    JAX package's CLIs run it. The workers are spawned, not forked: a
    caller may have threads (a CUDA context, a server), and a forked child
    could inherit a lock one of them holds. A worker that dies raises
    BrokenProcessPool here instead of leaving the map waiting.
    `processes == 1` runs in this process and starts none: a spawned
    worker re-imports the caller's main script, which costs seconds where
    that script imports torch."""
    if processes == 1:
        return [fn(job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(processes, mp_context=ctx) as pool:
        return list(pool.map(fn, jobs))
