"""The services' hook for the ``/metrics`` + ``/healthz`` endpoint.

The endpoint itself (``aios_tpu/obs/http.py``: the exposition server, its
``/debug`` routes, the fleet announce and the history planes) is not ported
yet (ROADMAP Queue 1 item 5). Every service's ``serve`` calls
``maybe_start_metrics_server`` as the JAX services do; here it starts
nothing, and when the endpoint was asked for it logs a warning naming the
knob, so a configuration that expects one does not pass unnoticed. It never
starts a partial endpoint.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Tuple

log = logging.getLogger("aios.obs.http")


def maybe_start_metrics_server(
    service_name: str,
    metrics_port: Optional[int] = None,
    health_fn: Optional[Callable[[], dict]] = None,
) -> Tuple[None, None]:
    """(None, None); warns when ``metrics_port`` or
    ``AIOS_<SERVICE>_METRICS_PORT`` asks for the endpoint."""
    knob = f"AIOS_{service_name.upper()}_METRICS_PORT"
    if metrics_port is not None or os.environ.get(knob):
        log.warning(
            "%s is set but the metrics endpoint is not ported yet (ROADMAP "
            "Queue 1 item 5): %s serves no /metrics", knob, service_name,
        )
    return None, None
