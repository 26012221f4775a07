"""The dense transformer of the serve path; port of `repro.models`
(`layers`, `attention`, `transformer`) for the ``attn`` block pattern."""
