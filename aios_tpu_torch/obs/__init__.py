"""Observability for the port, the JAX package's ``obs`` less its fleet plane:

  * ``obs.metrics``     — the thread-safe Prometheus-style registry;
  * ``obs.instruments`` — the catalog of every family the port registers;
  * ``obs.tracing``     — spans with W3C ``traceparent`` propagation;
  * ``obs.interceptors``— the gRPC client/server interceptors (rpc_*
                          metrics and the span tree), installed by
                          ``aios_tpu_torch.rpc``;
  * ``obs.flightrec``   — the serving plane's flight recorder, with the
                          finished spans folded into its timelines;
  * ``obs.slo``         — windowed TTFT/TPOT/availability objectives;
  * ``obs.devprof``     — the device ledger: per-graph dispatch counts,
                          analytic cost of each captured CUDA graph, sampled
                          CUDA-event times and the card's roofline shares;
  * ``obs.http``        — the /metrics, /healthz and /debug endpoint;
  * ``obs.tsdb``        — the black-box time-series ring;
  * ``obs.incidents``   — incident bundles frozen around anomaly triggers.

Everything but ``devprof``'s sampling and capture is host code; no module
here imports torch when it is imported.
"""

from __future__ import annotations

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from .tracing import (  # noqa: F401
    Span,
    current_span,
    current_traceparent,
    parse_traceparent,
    recent_spans,
    start_span,
)
from .http import start_metrics_server, maybe_start_metrics_server  # noqa: F401
from . import flightrec  # noqa: F401
from . import slo  # noqa: F401 - registers the recorder's SLO listener
from . import tsdb  # noqa: F401 - black-box time-series ring
from . import incidents  # noqa: F401 - anomaly incident bundles
from .flightrec import RECORDER, FlightRecorder, Timeline  # noqa: F401

# finished spans fold into the matching request timeline by trace id (a
# deployment's own set_exporter call, made before or after import, wins)
flightrec.install_span_export()
