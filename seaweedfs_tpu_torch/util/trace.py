"""The tracing hooks the ported modules call, from the JAX package's
util/trace.py.

`current_sampled()` returns the sampled span context of the running
request, `span()` a child span of it, `span_root()` a root span for a
background plane, `batch_span()` the span a batch flush records linked to
its members, and `flag()` marks the running trace for the tail sampler (a
hedge, a retry). The port has no request entry point that starts a
trace yet, so no request is ever sampled: `current_sampled` returns
None, the three span functions the shared no-op span and `flag` does
nothing, which costs the gates, the group-commit worker, the read
fan-out and the filer's chunk writes nothing.
"""

from __future__ import annotations


class _NullSpan:
    """Shared no-op context manager for the unsampled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

# promotion flags (the JAX module's values)
FLAG_ERROR = 1
FLAG_RETRY = 2
FLAG_HEDGE = 4
FLAG_FAULT = 8
FLAG_SHED = 16


def flag(bits: int) -> None:
    """Mark the running trace for the tail sampler; nothing samples yet."""


def current_sampled():
    return None


def batch_span(name: str, members, **tags):
    """Flush span for a batch seam; the no-op span while nothing samples."""
    return NULL_SPAN


def span(name: str, **tags):
    """Child span of the running request; the no-op span while nothing
    samples."""
    return NULL_SPAN


def span_root(name: str, **tags):
    """Root span of a background plane; the no-op span while nothing
    records."""
    return NULL_SPAN
