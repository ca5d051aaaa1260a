"""Per-sample promise/future with incremental readiness.

Counterpart of ProcessingResultsPromise/Future
(reference: src/processing_results.cpp:34-257 — shared state, per-sample
`set`, `waitForAll`, and incremental `wait_new` at :78-93). The scheduler
uses it to stream per-sample completions so fallback re-routing can happen
while the batch is still in flight (src/decoder_worker.cpp:158-199).
"""
from __future__ import annotations

import threading
from typing import Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class _SharedState(Generic[T]):
    def __init__(self, n: int):
        self.n = n
        self.results: List[Optional[T]] = [None] * n
        self.ready: List[bool] = [False] * n
        self.num_ready = 0
        self.consumed: set = set()  # indices handed out via wait_new
        self.cv = threading.Condition()


class ProcessingResultsFuture(Generic[T]):
    """Consumer side (reference: ProcessingResultsFuture,
    src/processing_results.cpp:95-257)."""

    def __init__(self, state: _SharedState[T]):
        self._state = state

    def wait_all(self, timeout: Optional[float] = None) -> List[T]:
        s = self._state
        with s.cv:
            if not s.cv.wait_for(lambda: s.num_ready == s.n, timeout):
                raise TimeoutError("processing results not ready")
            return list(s.results)  # type: ignore[arg-type]

    def wait_new(self, timeout: Optional[float] = None) -> List[Tuple[int, T]]:
        """Block until at least one not-yet-consumed result is ready; return
        [(index, result)] of newly ready samples. Returns [] only once every
        sample has been consumed; raises TimeoutError if the wait expires with
        nothing new (reference: wait_new, src/processing_results.cpp:78-93)."""
        s = self._state
        with s.cv:
            if len(s.consumed) == s.n:
                return []
            if not s.cv.wait_for(lambda: s.num_ready > len(s.consumed), timeout):
                raise TimeoutError("no new processing results within timeout")
            out = []
            for i in range(s.n):
                if s.ready[i] and i not in s.consumed:
                    s.consumed.add(i)
                    out.append((i, s.results[i]))
            return out  # type: ignore[return-value]

    def ready_count(self) -> int:
        with self._state.cv:
            return self._state.num_ready

    def get(self, i: int, timeout: Optional[float] = None) -> T:
        s = self._state
        with s.cv:
            if not s.cv.wait_for(lambda: s.ready[i], timeout):
                raise TimeoutError(f"sample {i} not ready")
            return s.results[i]  # type: ignore[return-value]


class ProcessingResultsPromise(Generic[T]):
    """Producer side (reference: ProcessingResultsPromise,
    src/processing_results.cpp:230-257)."""

    def __init__(self, n: int):
        self._state: _SharedState[T] = _SharedState(n)

    @property
    def num_samples(self) -> int:
        return self._state.n

    def future(self) -> ProcessingResultsFuture[T]:
        return ProcessingResultsFuture(self._state)

    def set(self, index: int, result: T) -> None:
        s = self._state
        with s.cv:
            if s.ready[index]:
                raise RuntimeError(f"result {index} already set")
            s.results[index] = result
            s.ready[index] = True
            s.num_ready += 1
            s.cv.notify_all()

    def set_all(self, results: List[T]) -> None:
        for i, r in enumerate(results):
            self.set(i, r)
