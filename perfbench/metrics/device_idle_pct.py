"""Share of the traced window in which no device operation ran: one minus
the device's busy time (the union of its operations' intervals) over the
traced window's wall time, ``busy_s`` / ``window_s`` of the result."""
LAYER = "device: H100"
MOVES = "train_tok_s"
UNIT = "%"


def read(ctx):
    if not ctx.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
