"""Share of the device-only span pass (``spans.py``: two rounds under a
profiler that records device activity alone, batch making included) in
which no device operation ran: one minus the union of the operations'
intervals over the pass's wall time."""
from perfbench import spans

LAYER = "device: H100"
MOVES = "train_tok_s"
UNIT = "%"


def read(ctx):
    p = spans.of(ctx)
    return 100.0 * (1.0 - p.busy_ns / p.window_ns) \
        if p and p.read() else None
