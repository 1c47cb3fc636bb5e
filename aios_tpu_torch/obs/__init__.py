"""Observability for the port's serving plane: copies of the JAX package's
``obs/metrics.py`` (the registry), ``obs/instruments.py`` (the families the
serving plane touches) and ``obs/flightrec.py`` (the flight recorder).
``obs/http.py`` holds only the services' endpoint hook, which warns and
starts nothing. Tracing, the HTTP endpoint, SLOs, the fleet plane, the tsdb
and incident bundles are not ported yet.
"""

from __future__ import annotations

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from . import flightrec  # noqa: F401
from .flightrec import RECORDER, FlightRecorder, Timeline  # noqa: F401
