"""build (`pipelines/build_index.py`, `models/train.py::train_epoch`): the
training stage's seconds, from the port's own stage timer line
`>> training time: <s>s` of `build_index`."""


def read(ctx):
    return ctx.spans.get("training")
