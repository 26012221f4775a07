"""The corpus and the queries of a cell, made from ``--seed``.

`mf_factors` is a copy of the repo's PureSVD-style generator (the same seed
gives the same floats), kept here so that the yardstick does not move when
the program's copy does. Each stream of random numbers (corpus order,
queries, writes, sample) has its own 32-bit seed derived from ``--seed``
and a tag, so any whole number, however large, is a valid seed.

The corpus is a fixed data set, as the paper's are: the configuration's
recipe drawn from its own ``data_seed``, its rows put in an order drawn
from ``--seed``. Each run then searches the same rows under other ids, and
the seed changes which queries come and under which ids, not how much
work the index does (with rows drawn from ``--seed``, recall and the pages
a query moved from seed to seed; PERF.md has the readings).
"""
from __future__ import annotations

import numpy as np

TAGS = {"corpus": 0, "queries": 1, "writes": 2, "sample": 3}


def derive(seed: int, tag: str) -> int:
    """A 32-bit seed for the stream ``tag`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, TAGS[tag]])
    return int(ss.generate_state(1, np.uint32)[0])


def mf_factors(n: int, d: int, rank: int, *, decay: float = 0.3, seed: int = 0,
               norm_tail: float = 0.0) -> np.ndarray:
    """PureSVD-style latent factors: U diag(s) V with decaying spectrum.
    ``norm_tail`` > 0 adds a lognormal per-point scale (long-tail norms)."""
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((n, rank))
    v = rng.standard_normal((rank, d))
    return _factors(u, v, decay, rng, norm_tail)


def _factors(u, v, decay, rng, norm_tail):
    spec = np.exp(-decay * np.arange(u.shape[1]))
    x = (u * spec) @ v
    if norm_tail > 0:
        x *= rng.lognormal(0.0, norm_tail, size=(len(x), 1))
    return x.astype(np.float32)


def mf_factors_basis(n: int, d: int, rank: int, *, decay: float = 0.3,
                     seed: int = 0, basis_seed: int = 0) -> np.ndarray:
    """`mf_factors` with no norm tail and the factor basis V drawn from
    ``basis_seed`` (a fixed number of the configuration), the rows from
    ``seed``. Every run then draws its rows from the same latent space, so
    a run's seed changes which rows it gets, not how hard they are to
    search: with V drawn from the run's seed, the pages a query verifies
    differ by 2.4x between seeds at 100,000 rows."""
    v = np.random.RandomState(basis_seed).standard_normal((rank, d))
    u = np.random.RandomState(seed).standard_normal((n, rank))
    return _factors(u, v, decay, None, 0.0)


RECIPES = {"mf_factors": mf_factors, "mf_factors_basis": mf_factors_basis}


def make(recipe: dict, n: int, d: int, seed: int) -> np.ndarray:
    """``n`` rows of width ``d`` of ``recipe`` ({"recipe": name, "rank": ..,
    ...}) from the 32-bit ``seed``."""
    kw = {k: v for k, v in recipe.items()
          if k not in ("recipe", "rank", "data_seed")}
    return RECIPES[recipe["recipe"]](int(n), int(d), int(recipe["rank"]),
                                     seed=seed, **kw)


def corpus(config: dict, seed: int) -> np.ndarray:
    """The configuration's (n, d) float32 corpus for run ``seed``: its rows
    drawn from the recipe's ``data_seed``, in an order drawn from
    ``seed``."""
    recipe = config["corpus"]
    x = make(recipe, config["n"], config["d"], int(recipe["data_seed"]))
    order = np.random.default_rng(derive(seed, "corpus")).permutation(len(x))
    return x[order]


def new_rows(config: dict, count: int, seed: int) -> np.ndarray:
    """``count`` rows more of the corpus's own distribution, as a catalog
    gains items: the `mf_factors` corpus's basis V (drawn from its
    ``data_seed`` after the corpus's U) with fresh U and norm tail from the
    32-bit ``seed``."""
    recipe, n, d = config["corpus"], int(config["n"]), int(config["d"])
    if recipe["recipe"] != "mf_factors":
        raise ValueError(f"no new rows for recipe {recipe['recipe']!r}")
    rank = int(recipe["rank"])
    base = np.random.RandomState(int(recipe["data_seed"]))
    base.standard_normal((n, rank))
    v = base.standard_normal((rank, d))
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((int(count), rank))
    return _factors(u, v, float(recipe["decay"]), rng,
                    float(recipe.get("norm_tail", 0.0)))
