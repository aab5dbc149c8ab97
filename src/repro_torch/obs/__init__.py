"""Unified observability plane: metrics registry + lifecycle tracer.

The port's own copy of the JAX package's ``obs/`` (see
docs/OBSERVABILITY.md). Its instruments keep the JAX names with
``plane_`` read as ``plane_torch_``: planelint's metrics-discipline pass
forbids declaring one name twice under ``src/``. Import surface:

* instruments — :func:`counter` / :func:`gauge` / :func:`histogram`
  declare module-scope handles; ``handle.cell(**labels)`` yields a
  per-instance accumulator bound to the active registry.
* registry — :class:`MetricsRegistry`, :func:`active` /
  :func:`install` / :func:`installed`, Prometheus/JSON exporters.
* tracing — :class:`Tracer`, module-level :func:`emit`,
  :func:`install_tracer` / :func:`installed_tracer`,
  :func:`chrome_trace` / :func:`validate_spans` /
  :func:`spans_from_store`.
* program spans — :func:`span` opens ``knd.<name>`` ranges on the
  clock of a ``torch.profiler`` profile (and their backward twins
  ``knd.<name>.bwd``) while one records, and costs one flag read
  otherwise.
* :func:`dump_artifacts` — what ``--obs-dir`` entry points call at
  exit; writes ``metrics.prom`` / ``metrics.json`` / ``spans.json``
  for ``scripts/obsctl.py`` to consume out-of-process.

This package imports nothing from the rest of ``repro_torch`` (nor
anything of ``repro``), so every plane can instrument itself without
import cycles. It needs only the standard library; :func:`span` imports
torch only while a profile records.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .registry import (                                        # noqa: F401
    DEFAULT_BUCKETS, MAX_LABEL_SETS, PREFIX, MetricError,
    InstrumentHandle, MetricsRegistry, NULL_CELL, active, catalog,
    counter, default_registry, gauge, histogram, install, installed,
    quantile)
from .trace import (                                           # noqa: F401
    NO_SPAN, SPAN_PREFIX, TRACKED_CONDITIONS, Span, Tracer, active_tracer,
    chrome_trace, emit, install_tracer, installed_tracer, span,
    spans_from_store, validate_spans)

METRICS_PROM = "metrics.prom"
METRICS_JSON = "metrics.json"
SPANS_JSON = "spans.json"


def dump_artifacts(obs_dir: str,
                   registry: Optional[MetricsRegistry] = None,
                   tracer: Optional[Tracer] = None) -> Dict[str, str]:
    """Write the obs artifacts an ``--obs-dir`` run leaves behind.

    Returns ``{artifact name: path}`` for whatever was written.
    """
    os.makedirs(obs_dir, exist_ok=True)
    reg = registry if registry is not None else active()
    out: Dict[str, str] = {}
    prom = os.path.join(obs_dir, METRICS_PROM)
    with open(prom, "w") as f:
        f.write(reg.render_prometheus())
    out[METRICS_PROM] = prom
    mjson = os.path.join(obs_dir, METRICS_JSON)
    with open(mjson, "w") as f:
        f.write(reg.render_json())
        f.write("\n")
    out[METRICS_JSON] = mjson
    if tracer is not None:
        out[SPANS_JSON] = tracer.export(os.path.join(obs_dir, SPANS_JSON))
    return out
