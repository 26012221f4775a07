"""Index build (`core/index.py` `build_index` through `ProMIPS.build` or
`api.build`, with the copy of its arrays to the card): the host clock
around the entry's build call in set-up. Moves `setup_s`."""


def read(ctx):
    return ctx.setup.get("build_s")
