"""build (`models/train.py::train_epoch` in `pipelines/build_index.py` and
`pipelines/largescale.py`): seconds of one training epoch, the port's
`>> training epoch time: <s>s` stage lines summed over the build and
divided by the configuration's `n_epoch`.  None where the build prints no
such line."""


def read(ctx):
    s = ctx.spans.get("training epoch")
    n = ctx.config["index"]["config"].get("n_epoch")
    return s / n if s is not None and n else None
