"""Labeled metrics registry with Prometheus text exposition (paper §3
'Application profiling').

The paper's platform feeds Prometheus/Grafana; this module is that metrics
surface: Counter / Gauge / Histogram instruments keyed by label sets, a
:class:`MetricsRegistry` that owns them, and a text-exposition renderer in
the Prometheus format (``# HELP`` / ``# TYPE`` comment lines, then one
``name{label="value"} value`` sample per line, histograms as cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``).

:func:`parse_exposition` is the inverse — a strict line-by-line validator
used by the CI smoke test, which also checks histogram bucket monotonicity
and ``_count`` == the ``+Inf`` bucket.

Everything here is plain host-side Python (no jax, no serving imports), so
the serving layer can import it lazily without touching the core package's
import cycle, and instruments are cheap enough to update per engine step.
"""
from __future__ import annotations

import dataclasses
import math
import re

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\":
            if i + 1 >= len(v):
                raise ValueError(f"dangling escape in label value {v!r}")
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ('"', "\\"):
                out.append(nxt)
            else:
                raise ValueError(f"bad escape \\{nxt} in label value {v!r}")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Metric:
    """Base instrument: a family of samples keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_str(self, key: tuple[str, ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = list(zip(self.labelnames, key)) + list(extra)
        if not pairs:
            return ""
        body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
        return "{" + body + "}"

    def samples(self) -> list[tuple[str, str, float]]:
        """(sample name, rendered label string, value) triples."""
        raise NotImplementedError

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for name, labels, v in self.samples():
            lines.append(f"{name}{labels} {_fmt(v)}")
        return lines


class Counter(Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._v: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc {amount})")
        k = self._key(labels)
        self._v[k] = self._v.get(k, 0.0) + float(amount)

    def peg(self, total: float, **labels) -> None:
        """Mirror an externally-maintained cumulative total (e.g. the prefix
        cache's own ``hit_tokens`` counter) without double counting: the
        sample is raised to ``total`` and never lowered."""
        k = self._key(labels)
        self._v[k] = max(self._v.get(k, 0.0), float(total))

    def value(self, **labels) -> float:
        return self._v.get(self._key(labels), 0.0)

    def samples(self):
        return [(self.name, self._label_str(k), v)
                for k, v in sorted(self._v.items())]


class Gauge(Metric):
    """A value that goes up and down."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._v: dict[tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        self._v[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        self._v[k] = self._v.get(k, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._v.get(self._key(labels), 0.0)

    def samples(self):
        return [(self.name, self._label_str(k), v)
                for k, v in sorted(self._v.items())]


DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics: every bucket
    counts observations ``<= le``; ``+Inf`` is implicit and equals
    ``_count``)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = b
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sum: dict[tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
        # non-cumulative internally; cumulated at render time
        for i, le in enumerate(self.buckets):
            if value <= le:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sum[k] = self._sum.get(k, 0.0) + float(value)

    def count(self, **labels) -> int:
        return sum(self._counts.get(self._key(labels), []))

    def samples(self):
        out = []
        for k, counts in sorted(self._counts.items()):
            cum = 0
            for le, c in zip(self.buckets, counts):
                cum += c
                out.append((self.name + "_bucket",
                            self._label_str(k, (("le", _fmt(le)),)), cum))
            cum += counts[-1]
            out.append((self.name + "_bucket",
                        self._label_str(k, (("le", "+Inf"),)), cum))
            out.append((self.name + "_sum", self._label_str(k), self._sum[k]))
            out.append((self.name + "_count", self._label_str(k), cum))
        return out


class MetricsRegistry:
    """Owns every instrument; get-or-create accessors are idempotent so the
    engine, the scheduler hook, and the control plane can all ask for the
    same family — but a type or label-set mismatch is a hard error."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name, help, labelnames, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls:
                raise ValueError(f"{name} already registered as "
                                 f"{type(m).__name__}, not {cls.__name__}")
            if m.labelnames != tuple(labelnames):
                raise ValueError(f"{name} already registered with labels "
                                 f"{m.labelnames}, not {tuple(labelnames)}")
            return m
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def render(self) -> str:
        """Full Prometheus text exposition, families in name order."""
        lines = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------- validation
@dataclasses.dataclass
class Exposition:
    """Parsed exposition: sample values keyed by (name, label pairs)."""
    types: dict[str, str]
    helps: dict[str, str]
    samples: dict[tuple[str, tuple[tuple[str, str], ...]], float]

    def value(self, name: str, **labels) -> float:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        return self.samples[key]


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+(-?\d+))?$")


def _parse_labels(body: str, line: str) -> tuple[tuple[str, str], ...]:
    pairs, i = [], 0
    while i < len(body):
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', body[i:])
        if not m:
            raise ValueError(f"malformed label set in line: {line!r}")
        name = m.group(1)
        i += m.end()
        j, val = i, []
        while j < len(body):
            if body[j] == "\\":
                val.append(body[j:j + 2])
                j += 2
            elif body[j] == '"':
                break
            else:
                val.append(body[j])
                j += 1
        else:
            raise ValueError(f"unterminated label value in line: {line!r}")
        pairs.append((name, _unescape_label("".join(val))))
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
        elif i < len(body):
            raise ValueError(f"malformed label set in line: {line!r}")
    return tuple(sorted(pairs))


def _parse_value(s: str, line: str) -> float:
    if s in ("+Inf", "Inf"):
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"bad sample value {s!r} in line: {line!r}") from None


def parse_exposition(text: str) -> Exposition:
    """Validate + parse Prometheus text exposition line by line.

    Raises ``ValueError`` on any malformed line, a duplicated sample, a
    ``# TYPE`` naming an unknown kind, histogram buckets that are not
    cumulative, or a histogram ``_count`` that disagrees with its ``+Inf``
    bucket — this is the CI smoke test's format checker.
    """
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    samples: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ValueError(f"bad metric name in HELP line: {line!r}")
            helps[name] = help_text
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"malformed TYPE line: {line!r}")
            if parts[3] not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                raise ValueError(f"unknown metric type in line: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue                      # free-form comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed sample line: {line!r}")
        name, label_body, value_s = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(label_body, line) if label_body else ()
        key = (name, labels)
        if key in samples:
            raise ValueError(f"duplicate sample: {line!r}")
        samples[key] = _parse_value(value_s, line)

    # histogram self-consistency
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        series: dict[tuple[tuple[str, str], ...], list[tuple[float, float]]] = {}
        for (name, labels), v in samples.items():
            if name != fam + "_bucket":
                continue
            le = next((lv for ln, lv in labels if ln == "le"), None)
            if le is None:
                raise ValueError(f"{name}: bucket sample without le label")
            base = tuple(p for p in labels if p[0] != "le")
            series.setdefault(base, []).append(
                (_parse_value(le, le), v))
        for base, buckets in series.items():
            buckets.sort(key=lambda b: b[0])
            counts = [c for _, c in buckets]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ValueError(
                    f"{fam}{dict(base)}: bucket counts not cumulative")
            if not buckets or not math.isinf(buckets[-1][0]):
                raise ValueError(f"{fam}{dict(base)}: missing +Inf bucket")
            cnt = samples.get((fam + "_count", base))
            if cnt is None or cnt != buckets[-1][1]:
                raise ValueError(
                    f"{fam}{dict(base)}: _count != +Inf bucket")
    return Exposition(types=types, helps=helps, samples=samples)
