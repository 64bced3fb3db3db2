"""The training loop's failure taxonomy (port of lingvo_tpu/core/retry.py).

Transient infrastructure errors (Unavailable / Aborted / deadline /
connection loss: what a lost host or a dropped reader produce) are
retryable, by restoring the last checkpoint; compilation, shape and type
errors are the program's and fatal. On the card a CUDA fault is fatal too:
an illegal memory access or a launch failure leaves the context unusable
and is a kernel's bug, never a preemption, so it is never retried from a
checkpoint. The reference's backoff decorator `Retry`, which nothing
calls, is not ported.
"""

from __future__ import annotations

# Substrings of retryable infrastructure failures.
TRANSIENT_PATTERNS = (
    "UNAVAILABLE",
    "Unavailable",
    "DEADLINE_EXCEEDED",
    "DeadlineExceeded",
    "ABORTED",
    "Socket closed",
    "Connection reset",
    "connection attempts failed",
    "failed to connect",
    "heartbeat failure",
)

# Substrings of failures that are never retried, even beside
# transient-looking text.
FATAL_PATTERNS = (
    "Compilation failure",
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "INVALID_ARGUMENT",
    "CUDA error",
    "illegal memory access",
    "unspecified launch failure",
    "OutOfMemoryError",
    "CUDA out of memory",
)


def IsTransient(exc: BaseException) -> bool:
  """True when `exc` looks like a retryable infrastructure failure."""
  text = f"{type(exc).__name__}: {exc}"
  if any(pat in text for pat in FATAL_PATTERNS):
    return False
  return any(pat in text for pat in TRANSIENT_PATTERNS)

