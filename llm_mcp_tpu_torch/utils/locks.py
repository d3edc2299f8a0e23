"""Ranked locks (counterpart of `llm_mcp_tpu/utils/locks.py`, trimmed to
what the paged-KV ledger needs).

Every lock carries a rank, and a thread may only acquire a lock of
strictly higher rank than any lock it already holds. A violation raises
at once instead of deadlocking later; re-entrant acquisition is refused
the same way.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def _held() -> list[tuple[int, str]]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class LockOrderError(RuntimeError):
    """A thread tried to acquire a lock out of rank order."""


class OrderedLock:
    """threading.Lock plus the per-thread rank check."""

    def __init__(self, name: str, rank: int):
        self.name = name
        self.rank = rank
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = _held()
        if stack and stack[-1][0] >= self.rank:
            raise LockOrderError(
                f"lock order violation: acquiring {self.name!r} (rank {self.rank}) "
                f"while holding {stack[-1][1]!r} (rank {stack[-1][0]})"
            )
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            stack.append((self.rank, self.name))
        return ok

    def release(self) -> None:
        stack = _held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == (self.rank, self.name):
                del stack[i]
                break
        self._lock.release()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()
