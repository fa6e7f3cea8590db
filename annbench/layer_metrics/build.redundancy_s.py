"""build (`pipelines/build_index.py::build_index`, `duplicate_type "model"`:
`predict_counts`, `select_top_ratio`, `infer`, `apply_redundancy_subset`):
the learned redundancy's seconds, from the port's own stage timer line
`>> redundancy time: <s>s`.  None where the build prints no such line (no
learned redundancy, or a program without its timer)."""


def read(ctx):
    return ctx.spans.get("redundancy")
