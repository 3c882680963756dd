"""Host time a round of the program's batch making: the harness's span
around ``launch/train.round_batch`` (the loader's token draws in numpy and
the copy to the device), in ms a round."""
LAYER = "data feed: launch/train.round_batch and data/loader"
MOVES = "train_tok_s"
UNIT = "ms/round"


def read(ctx):
    calls = ctx.spans.get("batch")
    return 1e3 * sum(calls) / len(calls) if calls else None
