"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on one card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer metric sits in a file of its own, found by the
name `BENCHMARK.json` gives it:

  configs/<config>.json     corpus recipe and size, entry point, the user's
                            choices (guarantee, k, m, prefilter), the
                            reference and the limits that decide `correct`
  traffic/<mix>.json        the parameters of the closed loop (`traffic.py`)
  entries/<entry>.py        how the port is built and searched
  reference/<ref>.py        the plain reference (torch only, no port code)
  metrics/<metric>.py       one reader per per-layer metric

Nothing here imports `jax`, `jaxlib`, `flax` or the JAX package `repro`.
"""
