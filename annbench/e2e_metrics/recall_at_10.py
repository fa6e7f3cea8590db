"""Mean recall@10 of the recall sample's served queries (pool positions
spread evenly over the pool) against their exact kNN, which the reference
computes after the window."""


def read(ctx):
    return ctx.recall
