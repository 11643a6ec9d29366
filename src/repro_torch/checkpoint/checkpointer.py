"""Atomic npz checkpoints of the port's params and optimizer state (the JAX
package's ``checkpoint/checkpointer.py``), written in the JAX package's
layout so a checkpoint from either package restores in the port.

Commit protocol: write everything into ``step_<n>.tmp/``, then rename to
``step_<n>/`` — a crash mid-write never corrupts the latest complete
checkpoint (restore scans for the highest committed step, ``meta.json``
present). Files: ``params.npz``, ``opt.npz`` (``m/...``, ``v/...``,
``step``) and ``meta.json``, one npz entry a leaf under "/"-joined keys of
the reference's stacked tree (``blocks/l0/attn/wq``: the per-layer lists
stacked on a leading axis, ``convert.lm_params_to_numpy``).

Leaves keep their dtype. A bfloat16 leaf is written as the bytes
``np.savez`` writes for an ``ml_dtypes.bfloat16`` array (descr ``<V2``)
and a 2-byte void entry reads back as bfloat16: the reference writes its
bfloat16 leaves so but cannot restore them (ROADMAP C8).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.device import resolve_device


def _flatten(tree, prefix="") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: dict) -> dict:
    """Rebuild a nested dict from 'a/b/c' keys."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _savez(path: str, arrays: dict):
    """``np.savez(path, **arrays)``, byte for byte, but for a bfloat16
    leaf (``convert.BF16_VOID``) the header names ``<V2`` as it does for an
    ``ml_dtypes.bfloat16`` array."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if val.dtype == convert.BF16_VOID:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": val.shape})
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(fid, val)


class Checkpointer:
    """Checkpoints of ``cfg``'s parameter trees in ``directory``, the last
    ``keep`` kept; ``restore`` puts them on ``device``."""

    def __init__(self, directory: str, cfg, keep: int = 3, device="cuda"):
        self.dir = directory
        self.cfg = cfg
        self.keep = keep
        self.device = resolve_device(device)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.dir,
                            f"step_{step:08d}" + (".tmp" if tmp else ""))

    def save(self, params, opt_state, step: int):
        tmp = self._path(step, tmp=True)
        final = self._path(step)
        if os.path.exists(final):
            return
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        tree = lambda t: convert.lm_params_to_numpy(  # noqa: E731
            t, keep_dtype=True)
        _savez(os.path.join(tmp, "params.npz"), _flatten(tree(params)))
        _savez(os.path.join(tmp, "opt.npz"), _flatten({
            "m": tree(opt_state["m"]), "v": tree(opt_state["v"]),
            "step": convert.tensor_to_numpy(opt_state["step"])}))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step}, f)
        os.replace(tmp, final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def restore_latest(self) -> Optional[Tuple[Any, Any, int]]:
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1])

    def restore(self, step: int):
        """Returns (params, opt_state, step): the port's trees on the
        checkpointer's device, each leaf in the dtype it was saved in (the
        step counter int64)."""
        path = self._path(step)
        with np.load(os.path.join(path, "params.npz")) as f:
            params = _unflatten(dict(f))
        with np.load(os.path.join(path, "opt.npz")) as f:
            opt = _unflatten(dict(f))
        tree = lambda t: convert.lm_params_from_numpy(  # noqa: E731
            self.cfg, t, device=self.device, keep_dtype=True)
        return tree(params), {
            "m": tree(opt["m"]), "v": tree(opt["v"]),
            "step": torch.tensor(int(opt["step"]), dtype=torch.int64,
                                 device=self.device)}, step
