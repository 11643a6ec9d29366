"""Bytes one launch of the decode-attention kernel (B4,
``decode_split_kernel`` in ``csrc/attention.cu``) has to move: the keys
and values of the ``n_valid = cur_len + 1`` positions it attends over,
the query and the output, each once."""


def launch_bytes(batch: int, heads: int, kv_heads: int, head_dim: int,
                 n_valid: int, itemsize: int, out_itemsize: int) -> int:
    kv = 2 * batch * n_valid * kv_heads * head_dim * itemsize
    q = batch * heads * head_dim * itemsize
    out = batch * heads * head_dim * out_itemsize
    return kv + q + out
