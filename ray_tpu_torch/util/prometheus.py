"""Prometheus text-format exposition (counterpart of
``ray_tpu/util/prometheus.py``).

``render()`` turns this process's metrics (``util/metrics.py``) into one
exposition document: counters get the ``_total`` suffix, histograms render
cumulative ``_bucket{le=...}`` series plus ``_sum`` and ``_count``, so a
stock Prometheus scraper ingests it unchanged. The JAX package also
renders its node manager's core counters (``_core_lines``); the port has
no node manager, so that part is left out.
"""

from __future__ import annotations

from typing import Dict, List


def _escape_label_value(v) -> str:
    # Exposition-format label escaping: backslash, double quote and
    # newline (a raw newline in a label value corrupts the document).
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and newline only (not quotes).
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(tags) -> str:
    if not tags:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in tags
    )
    return "{" + inner + "}"


def _exemplar_suffix(value, le) -> str:
    """OpenMetrics exemplar of one bucket, `` # {trace_id="..."} <value>
    <ts>``, or "" when the bucket has none."""
    ex = (value.get("exemplars") or {}).get(le)
    if not ex or not ex.get("trace_id"):
        return ""
    return (f' # {{trace_id="{_escape_label_value(ex["trace_id"])}"}} '
            f'{ex.get("value", 0.0)} {ex.get("ts", 0.0)}')


def _hist_lines(pname: str, tags, value) -> List[str]:
    """Cumulative `_bucket{le=...}` series plus `_sum`/`_count` for one
    histogram series point ({count, sum, bounds, buckets[, exemplars]})."""
    lines: List[str] = []

    def lbl(extra=None):
        items = list(tags) + ([extra] if extra else [])
        return _fmt_labels(items)

    cum = 0
    for b, c in zip(value.get("bounds", []), value["buckets"]):
        cum += c
        lines.append(f'{pname}_bucket{lbl(("le", b))} {cum}'
                     f'{_exemplar_suffix(value, b)}')
    lines.append(f'{pname}_bucket{lbl(("le", "+Inf"))} {value["count"]}'
                 f'{_exemplar_suffix(value, "+Inf")}')
    lines.append(f"{pname}_sum{lbl()} {value['sum']}")
    lines.append(f"{pname}_count{lbl()} {value['count']}")
    return lines


def _user_lines(report: Dict[str, Dict]) -> List[str]:
    lines: List[str] = []
    for name, m in sorted(report.items()):
        kind = m["type"]
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram"}[kind]
        pname = name if kind != "counter" or name.endswith("_total") \
            else f"{name}_total"
        help_ = m.get("help", "")
        if help_:
            lines.append(f"# HELP {pname} {_escape_help(help_)}")
        lines.append(f"# TYPE {pname} {ptype}")
        for tags_key, value in m["series"].items():
            if kind == "histogram":
                lines += _hist_lines(pname, tags_key, value)
            else:
                lines.append(f"{pname}{_fmt_labels(tags_key)} {value}")
    return lines


def render() -> str:
    """The exposition document of this process's metrics. Rendering is a
    sampling edge: the device gauges are refreshed first (throttled, and
    a no-op in a process that has not initialised CUDA)."""
    from . import device_metrics
    from . import metrics as user_metrics

    device_metrics.maybe_sample()
    return "\n".join(_user_lines(user_metrics.get_metrics_report())) + "\n"
