"""Render statistics: counters, distributions, ratios, categorized report.

Device-side equivalent of the reference's thread-local stats macros +
StatsAccumulator (src/core/stats.rs:14-276, :297-492): there are no threads
to merge, so counters are a flat host-side registry; device-side quantities
(rays traced, path vertices) arrive as reduced scalars pulled off the device
once per wave. `print_stats` reproduces the categorized pretty-printer
(category/title split on '/', :400-492).
"""
from __future__ import annotations

import sys
import threading
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class _Distribution:
    count: int = 0
    total: float = 0.0
    lo: float = float("inf")
    hi: float = float("-inf")

    def add(self, v: float, n: int = 1):
        self.count += n
        self.total += v * n
        self.lo = min(self.lo, v)
        self.hi = max(self.hi, v)


class Stats:
    """Global stats registry (reference: STATS_ACCUM global, stats.rs:297)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.memory: dict[str, int] = defaultdict(int)
        self.distributions: dict[str, _Distribution] = defaultdict(_Distribution)
        self.ratios: dict[str, list] = defaultdict(lambda: [0, 0])
        self.percents: dict[str, list] = defaultdict(lambda: [0, 0])

    def counter(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += int(n)

    def memory_counter(self, name: str, nbytes: int):
        with self._lock:
            self.memory[name] += int(nbytes)

    def distribution(self, name: str, value: float, n: int = 1):
        with self._lock:
            self.distributions[name].add(float(value), n)

    def ratio(self, name: str, num: int, denom: int):
        with self._lock:
            r = self.ratios[name]
            r[0] += int(num)
            r[1] += int(denom)

    def percent(self, name: str, num: int, denom: int):
        with self._lock:
            p = self.percents[name]
            p[0] += int(num)
            p[1] += int(denom)

    def clear(self):
        with self._lock:
            self.counters.clear()
            self.memory.clear()
            self.distributions.clear()
            self.ratios.clear()
            self.percents.clear()

    # --- reporting (mirrors stats.rs categorized printer) -------------------

    @staticmethod
    def _split(name: str):
        if "/" in name:
            cat, title = name.split("/", 1)
        else:
            cat, title = "", name
        return cat, title

    def report(self) -> str:
        by_cat: dict[str, list[str]] = defaultdict(list)

        def fmt_mem(b: float) -> str:
            if b >= 1 << 30:
                return f"{b / (1 << 30):9.2f} GiB"
            if b >= 1 << 20:
                return f"{b / (1 << 20):9.2f} MiB"
            return f"{b / 1024.0:9.2f} KiB"

        for name, v in sorted(self.counters.items()):
            if v == 0:
                continue
            cat, title = self._split(name)
            by_cat[cat].append(f"    {title:<42}{v:>12d}")
        for name, v in sorted(self.memory.items()):
            if v == 0:
                continue
            cat, title = self._split(name)
            by_cat[cat].append(f"    {title:<42}{fmt_mem(v):>12}")
        for name, d in sorted(self.distributions.items()):
            if d.count == 0:
                continue
            cat, title = self._split(name)
            avg = d.total / d.count
            by_cat[cat].append(f"    {title:<42}{avg:12.3f} avg [range {d.lo:g} - {d.hi:g}]")
        for name, (num, den) in sorted(self.percents.items()):
            if den == 0:
                continue
            cat, title = self._split(name)
            by_cat[cat].append(f"    {title:<42}{num:>12d} / {den:d} ({100.0 * num / den:.2f}%)")
        for name, (num, den) in sorted(self.ratios.items()):
            if den == 0:
                continue
            cat, title = self._split(name)
            by_cat[cat].append(f"    {title:<42}{num:>12d} / {den:d} ({num / den:.2f}x)")

        out = ["Statistics:"]
        for cat in sorted(by_cat):
            out.append(f"  {cat or 'Misc'}")
            out.extend(by_cat[cat])
        return "\n".join(out)

    def print(self, file=None):
        print(self.report(), file=file or sys.stderr)


STATS = Stats()


def report_stats():
    return STATS.report()


def print_stats(file=None):
    STATS.print(file)


def clear_stats():
    STATS.clear()
