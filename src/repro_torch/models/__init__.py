"""The models of the serve and training paths; port of `repro.models`
(`layers`, `attention`, `moe`, `transformer`) for the ``attn`` block
pattern (dense, MoE, the vision stub) and the ``encdec`` one (whisper).
The recurrent families (`ssm`, `xlstm`, `scan_util`) wait for ROADMAP
Queue 1 item 12."""
