"""Host counters and spans: the port's own copy of
`bulletproofs_tpu/utils/metrics.py`, the structured replacement for the
reference's ad-hoc `Instant::now()` + `println!` instrumentation.

Usage:
    with metrics.span("prove"):
        ...
    metrics.incr("multipliers", n)
    print(metrics.report())

`Prover.prove` records `prove_calls`, `multipliers` and `constraints` and
the span "prove"; `Verifier.verify` records `verify_calls` and the span
"verify", as the JAX package's do.  Enabled always (a dict update an
event); `BP_TRACE=1` also prints each span as it closes.  A span reads the
host's clock and never synchronises with the card: it times what the host
waited for (the fused IPA's one fetch, for a proof on the card), and the
device's own time is in a `torch.profiler` trace (chip_smoke.py `trace`).
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_PRINT = os.environ.get("BP_TRACE", "0") == "1"


class Metrics:
    def __init__(self):
        self.counters = defaultdict(int)
        self.timings = defaultdict(float)
        self.calls = defaultdict(int)

    def incr(self, name, value=1):
        self.counters[name] += value

    @contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] += dt
            self.calls[name] += 1
            if _PRINT:
                print(f"[bp-trace] {name}: {dt * 1e3:.2f} ms")

    def reset(self):
        self.counters.clear()
        self.timings.clear()
        self.calls.clear()

    def report(self):
        lines = []
        for name in sorted(self.timings):
            lines.append(f"{name}: {self.timings[name] * 1e3:.2f} ms "
                         f"over {self.calls[name]} call(s)")
        for name in sorted(self.counters):
            lines.append(f"{name}: {self.counters[name]}")
        return "\n".join(lines)


metrics = Metrics()
