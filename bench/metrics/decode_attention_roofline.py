"""The decode-attention kernel's (B4, ``decode_split_kernel``) device
time against the bytes of each launch's own ``cur_len``
(``bench/ops/decode_attention_bytes.py``) at 3.35 TB/s, over the traced
segments."""
from bench.reduce import roofline_pct


def read(run):
    return roofline_pct(run.summary, "decode_split_kernel",
                        run.record.get("decode_launch_bytes"))
