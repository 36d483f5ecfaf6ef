"""The two tracing hooks the lookup gate calls, from the JAX package's
util/trace.py.

`current_sampled()` returns the sampled span context of the running
request, and `batch_span()` the span a batch flush records linked to its
members. The port has no request entry point that starts a trace yet
(that comes with its servers), so no request is ever sampled:
`current_sampled` returns None and `batch_span` the shared no-op span,
which costs the gate nothing.
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


def current_sampled():
    return None


def batch_span(name: str, members, **tags):
    """Flush span for a batch seam; the no-op span while nothing samples."""
    return NULL_SPAN
