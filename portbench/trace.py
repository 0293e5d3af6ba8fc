"""The traced run: the benchmark's own spans, and the device trace read.

`install_spans` wraps the calls into each layer of one Scanner with
`torch.profiler.record_function` spans named `portbench.<layer>`; it is
installed in a `--trace 1` run only.  `Trace` reads a finished
`torch.profiler.profile`: device intervals (kernels, copies, sets) with
their names, and the host spans, in one time base.
"""

from __future__ import annotations

import functools

WINDOW_SPAN = "portbench.window"


def _spanned(name: str, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)

    return wrapper


def install_spans(scanner) -> None:
    """Spans around phase-1 dispatch and collect, phase-2 dispatch,
    collect and decode, and the products' write."""
    import deciphon_tpu_torch.scan.pipeline as pipeline

    scorer = scanner.scorer
    scorer.dispatch_all = _spanned("portbench.dispatch", scorer.dispatch_all)
    scorer.collect_all = _spanned("portbench.collect", scorer.collect_all)
    scanner._batched_paths_dispatch = _spanned(
        "portbench.phase2_dispatch", scanner._batched_paths_dispatch)
    scanner._batched_paths_collect = _spanned(
        "portbench.phase2_collect", scanner._batched_paths_collect)
    scanner._phase2 = _spanned("portbench.phase2_decode", scanner._phase2)

    base = pipeline.ProductWriter

    class SpannedWriter(base):
        close = _spanned("portbench.write", base.close)

    pipeline.ProductWriter = SpannedWriter


def _union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo if hi is not None else 0.0)


class Trace:
    """Device intervals and host spans of one profiled window (us)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device = []  # (name, start, end)
        self.spans = []  # (name, start, end), the benchmark's own
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                # a span also shows on the device's timeline: not work
                if (not getattr(e, "is_user_annotation", False)
                        and not e.name.startswith("portbench.")):
                    self.device.append((e.name, tr.start, tr.end))
            elif e.name.startswith("portbench."):
                self.spans.append((e.name, tr.start, tr.end))
        win = [s for s in self.spans if s[0] == WINDOW_SPAN]
        if win:
            self.lo, self.hi = win[0][1], win[0][2]
        else:  # no span: the device trace's own bounds
            self.lo = min((s for _, s, _ in self.device), default=0.0)
            self.hi = max((e for _, _, e in self.device), default=0.0)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which the card ran at least one kernel or copy: the
        union of the device intervals (streams overlap, so a sum would
        count shared time twice)."""
        return _union((s, e) for _, s, e in self.device) / 1e6

    def seconds(self, pattern) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        return sum(e - s for n, s, e in self.device
                   if pattern.search(n)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost span of the benchmark's that holds each
        gap's middle ("host" where none does)."""
        ops: dict[str, float] = {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        merged = []
        for a, b in sorted((s, e) for _, s, e in self.device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [self.lo] + [x for ab in merged for x in ab] + [self.hi]
        gaps: dict[str, float] = {}
        inner = sorted((s for s in self.spans if s[0] != WINDOW_SPAN),
                       key=lambda s: s[2] - s[1])
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            name = next((n[len("portbench."):] for n, s, e in inner
                         if s <= mid <= e), "host")
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": best(ops), "idle_gaps": best(gaps)}
