"""Shared LM-family shape set (assigned): seq_len x global_batch cells.

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``. ``long_500k`` requires sub-quadratic
attention: all five assigned LM archs are pure full-attention (GQA), so the
cell is marked skip (see DESIGN.md §Arch-applicability); the framework's
opt-in ``attn_window`` demonstrates the sub-quadratic path but is not part
of the faithful configs.
"""

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1,
                  "skip": "pure full-attention arch (sub-quadratic required)"},
}
