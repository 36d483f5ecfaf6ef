"""Small host utilities."""

import os as _os


def available_cpus() -> int:
    """CPUs this process may actually run on (cgroup/affinity-aware;
    sched_getaffinity is Linux-only, cpu_count the portable fallback)."""
    try:
        return len(_os.sched_getaffinity(0))
    except AttributeError:
        return _os.cpu_count() or 1
