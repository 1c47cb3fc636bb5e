"""Runtime lock verification for the serving plane: a copy of the runtime
half of ``aios_tpu/analysis`` (``locks.make_lock`` and its debug locks).
The static analyzer of the JAX package is not ported."""

from .locks import (  # noqa: F401
    DebugLock, LockOrderError, debug_enabled, make_lock, watchdog_trips,
)
