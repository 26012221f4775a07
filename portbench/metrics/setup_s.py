"""Set-up: process start to the first timed batch (host clock). Includes
the kernel library, the corpus and the queries, the host build, the copy to
the card and the warm-up."""


def read(ctx):
    return ctx.setup["setup_s"]
