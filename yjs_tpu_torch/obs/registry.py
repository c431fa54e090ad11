"""Zero-dependency metrics registry: counters, gauges, log-bucketed
histograms.

Cheap enough to leave on in the flush hot path: an ``observe``/``inc`` is
an attribute walk plus a dict increment (histograms add one ``math.log``),
and every instrument the engine touches per flush is pre-created at
engine construction, so no name lookup ever happens inside a flush.

When the registry is created disabled (``YTPU_OBS_DISABLED=1`` at engine
construction), every factory returns the shared no-op metric and the
exposition surface is empty — the hot path then pays a single branch.

Labels follow the Prometheus model: a metric family is registered once
with its label NAMES; ``labels(**values)`` returns (and caches) the child
holding the actual series.  Callers on hot paths should hold the child,
not re-resolve it per event.
"""

from __future__ import annotations

import math


class _NoopMetric:
    """Shared do-nothing stand-in when observability is disabled."""

    __slots__ = ()

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    def labels(self, **label_values):
        return self

    @property
    def value(self):
        return 0


NOOP_METRIC = _NoopMetric()


class _Metric:
    """Family/child base: a family carries label names and children; an
    unlabeled metric is its own single series."""

    kind = "untyped"

    __slots__ = ("name", "help", "unit", "labelnames", "_children")

    def __init__(self, name, help="", unit="", labelnames=()):
        self.name = name
        self.help = help
        self.unit = unit
        self.labelnames = tuple(labelnames)
        self._children = {} if self.labelnames else None

    def labels(self, **label_values):
        if not self.labelnames:
            return self
        key = tuple(str(label_values[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = type(self)(self.name, self.help, self.unit)
            self._children[key] = child
        return child

    def samples(self):
        """Yield ``(label_dict, series)`` pairs — one per child, or the
        metric itself when unlabeled."""
        if self.labelnames:
            for key in sorted(self._children):
                yield dict(zip(self.labelnames, key)), self._children[key]
        else:
            yield {}, self


class Counter(_Metric):
    """Monotonically increasing count (events, bytes)."""

    kind = "counter"

    __slots__ = ("_value",)

    def __init__(self, name, help="", unit="", labelnames=()):
        super().__init__(name, help, unit, labelnames)
        self._value = 0

    def inc(self, amount=1):
        self._value += amount

    @property
    def value(self):
        return self._value


class Gauge(_Metric):
    """Point-in-time value (occupancy, capacity, pool width)."""

    kind = "gauge"

    __slots__ = ("_value",)

    def __init__(self, name, help="", unit="", labelnames=()):
        super().__init__(name, help, unit, labelnames)
        self._value = 0

    def set(self, value):
        self._value = value

    def inc(self, amount=1):
        self._value += amount

    def dec(self, amount=1):
        self._value -= amount

    @property
    def value(self):
        return self._value


# 8 log-spaced buckets per octave (edges at 2**(i/8)): every observation
# lands within ~4.5% of its bucket's geometric midpoint, so p50/p95/p99
# read back with bounded relative error at O(1) memory per decade
_LOG_STEP = math.log(2.0) / 8.0


class Histogram(_Metric):
    """Log-bucketed distribution with p50/p95/p99 summaries.

    Exact ``count``/``sum``/``min``/``max`` are tracked alongside the
    buckets; quantiles interpolate to a bucket's geometric midpoint and
    are clamped into ``[min, max]``.  Zero/negative observations land in
    a dedicated underflow bucket (reported as ``min``)."""

    kind = "histogram"

    __slots__ = ("_buckets", "_zero", "_count", "_sum", "_min", "_max")

    def __init__(self, name, help="", unit="", labelnames=()):
        super().__init__(name, help, unit, labelnames)
        self._buckets = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value):
        v = float(value)
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v <= 0.0:
            self._zero += 1
        else:
            i = math.floor(math.log(v) / _LOG_STEP)
            self._buckets[i] = self._buckets.get(i, 0) + 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """The q-quantile (q in [0, 1]) from the bucket counts."""
        if not self._count:
            return 0.0
        target = q * self._count
        seen = self._zero
        if self._zero and seen >= target:
            return self._min
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if seen >= target:
                mid = math.exp((i + 0.5) * _LOG_STEP)
                return min(max(mid, self._min), self._max)
        return self._max

    def summary(self):
        if not self._count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        # all three quantiles from one sorted walk (this sits on the
        # TSDB sampler tick, which summarizes every histogram)
        targets = (0.50 * self._count, 0.95 * self._count,
                   0.99 * self._count)
        qs = [self._max, self._max, self._max]
        idx = 0
        seen = self._zero
        while idx < 3 and self._zero and seen >= targets[idx]:
            qs[idx] = self._min
            idx += 1
        if idx < 3:
            for i in sorted(self._buckets):
                seen += self._buckets[i]
                while idx < 3 and seen >= targets[idx]:
                    mid = math.exp((i + 0.5) * _LOG_STEP)
                    qs[idx] = min(max(mid, self._min), self._max)
                    idx += 1
                if idx == 3:
                    break
        return {
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "p50": qs[0],
            "p95": qs[1],
            "p99": qs[2],
        }


class MetricsRegistry:
    """Name -> metric-family map with Prometheus-style registration.

    Re-registering an existing name returns the existing family (so
    module-level consumers and the engine can share series); a kind
    mismatch on an existing name raises."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, unit, labelnames):
        if not self.enabled:
            return NOOP_METRIC
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, unit=unit, labelnames=labelnames)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}"
            )
        return m

    def counter(self, name, help="", unit="", labelnames=()):
        return self._register(Counter, name, help, unit, labelnames)

    def gauge(self, name, help="", unit="", labelnames=()):
        return self._register(Gauge, name, help, unit, labelnames)

    def histogram(self, name, help="", unit="", labelnames=()):
        return self._register(Histogram, name, help, unit, labelnames)

    def get(self, name):
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def collect(self):
        """Metric families in name order (empty when disabled)."""
        for name in sorted(self._metrics):
            yield self._metrics[name]
