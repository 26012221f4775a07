"""The models of the serve and training paths; port of `repro.models`
(`layers`, `attention`, `moe`, `ssm`, `xlstm`, `scan_util`,
`transformer`): the ``attn`` block pattern (dense, MoE, the vision stub),
the ``encdec`` one (whisper), and the recurrent ``xlstm_7_1`` and
``zamba2`` ones (served and trained)."""
