"""build (`pipelines/build_index.py::build_index`: `get_self_knn`, K2 at
"highest" on the card): the self-kNN's seconds, from the port's own stage
timer line `>> self knn time: <s>s`.  None where the build prints no such
line (a builder without the stage, or a program without its timer)."""


def read(ctx):
    return ctx.spans.get("self knn")
