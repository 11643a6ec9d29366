"""One rank of the port's sequence-sharded decode on the CPU, for
``tests/test_torch_seqshard.py`` (imports no JAX: every rank is a process
of its own, started by ``multiprocessing``'s spawn).

Rank r of ``world`` gloo ranks joins through a ``FileStore``, builds the
host mesh (world // 4, 4) on ("data", "model"), takes its data row's
batch rows and its shard of the cache's positions, decodes every prompt
token with ``seq_axis="model"``, and saves its logits; then it holds the
attention core alone, sharded, against the whole cache's plain decode at
several ``cur_len`` (shards past it included).
"""
from __future__ import annotations

import numpy as np


def run(rank: int, world: int, store_path: str, archs, params_paths,
        tokens: np.ndarray, out_paths) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import sharding
    from repro_torch.kernels.ref import decode_attn_ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, model_zoo

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(model_axis=4, device="cpu")
        B, S = tokens.shape
        n_data, n_seq = mesh.shape
        d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        rows = slice(d * B // n_data, (d + 1) * B // n_data)
        toks = torch.from_numpy(tokens[rows])
        core_err = check_core(mesh, m, n_seq, attention, decode_attn_ref,
                              sharding)
        for arch, params_path, out_path in zip(archs, params_paths,
                                               out_paths):
            cfg = get_smoke_config(arch)
            with np.load(params_path) as f:
                params = lm_params_from_numpy(cfg, unflatten(dict(f)),
                                              device="cpu")
            caches = model_zoo.init_decode_caches(cfg, toks.shape[0],
                                                  S // n_seq, device="cpu")
            logits = []
            with torch.no_grad(), sharding.activation_sharding(mesh):
                for i in range(S):
                    lg, caches = model_zoo.decode_fn(
                        cfg, params, toks[:, i:i + 1], caches, i,
                        seq_axis="model")
                    logits.append(lg.numpy())
            np.savez(out_path, logits=np.stack(logits),
                     rows=np.arange(B)[rows], core_err=core_err)
    finally:
        dist.destroy_process_group()


def check_core(mesh, m, n_seq, attention, decode_attn_ref, sharding):
    """The GQA core over this rank's quarter of a (2, 32, 2, 16) cache
    against ``decode_attn_ref`` over the whole, at cur_len 0, 5, 13 and 31
    (0 and 5: three shards wholly past cur_len). Returns the max error."""
    import torch

    g = torch.Generator().manual_seed(7)
    q = torch.randn((2, 1, 4, 16), generator=g)
    k = torch.randn((2, 32, 2, 16), generator=g)
    v = torch.randn((2, 32, 2, 16), generator=g)
    S_loc = 32 // n_seq
    err = 0.0
    with sharding.activation_sharding(mesh):
        shards = sharding.seq_shards("model")
        assert shards.size == n_seq and shards.coord == m
        for cur in (0, 5, 13, 31):
            kn, vn = k[:, cur:cur + 1], v[:, cur:cur + 1]
            cache = {"k": k[:, m * S_loc:(m + 1) * S_loc].clone(),
                     "v": v[:, m * S_loc:(m + 1) * S_loc].clone()}
            cache["k"][:, :] = torch.where(
                (torch.arange(S_loc) + m * S_loc <= cur)[None, :, None, None],
                cache["k"], 1e4)  # past cur_len: must not be read
            out = attention._cached_attention_core(q, kn, vn, cache, cur,
                                                   shards)
            want = decode_attn_ref(q[:, 0], k, v, cur)
            err = max(err, float((out - want).abs().max()))
    return err


def flatten(tree, prefix=""):
    """A nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
