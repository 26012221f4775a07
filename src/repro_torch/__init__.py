"""PyTorch + CUDA port of the ProMIPS search (see `src/repro/` for the JAX
reference it mirrors module by module).

The main path is the guaranteed c-k-AMIP batch search:
`core.promips.ProMIPS` -> `core.runtime.search` (two-phase, fused
verification, sketch prefilter) -> `core.search_fused.search_batch_fused`,
whose two hot kernels (`kernels.block_mips`, `kernels.sketch_scores`) are
CUDA C++ for Hopper, built from `kernels/csrc/` at first use. The streaming
index, `stream.MutableProMIPS` -> `core.runtime.search_segments`, runs the
same search over its base and scores its delta with a third kernel,
`kernels.mips_score`. The serve path, `serve.DecodeEngine`, decodes with
the dense transformer of `models` (its attention through
`kernels.decode_attention`) and picks tokens with exact logits or with the
batched ProMIPS search over the output embedding (`api`, ``promips-stream``;
the frontend's Quick-Probe bounds through `kernels.binary_probe`).
"""
