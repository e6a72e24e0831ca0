"""Checkpoint save/restore in the JAX package's format (the port of
``repro.ft.checkpoint``).

Layout::

    <dir>/manifest.json          # step, extra, and each leaf's shape, dtype, chunks
    <dir>/proc0.npz              # the chunks, one a leaf on one device

A leaf's key is its path as ``jax.tree_util.keystr`` writes it
(``tree.leaves_with_keys``), and its chunk is named ``_safe(key) + "__c0"``,
starting at zeros, so a checkpoint of a tree of the same structure restores
through either package's ``restore``. bf16 leaves are stored as the raw
2-byte void (``'V2'``) view of their 16-bit pattern, which is how the JAX
package's ``np.savez`` stores ``ml_dtypes.bfloat16``; the manifest names
their dtype ``"bfloat16"``. The port needs no ``ml_dtypes``.

:func:`save` writes the npz one leaf at a time (a zip64 archive of
``.npy`` members, which ``np.load`` reads), copying each leaf to the host
once, so the host holds one leaf at a time. :func:`restore` writes each
leaf into the template's own tensor (``copy_``), so the template's storage
survives and the peak stays at one state plus one leaf. A restore onto a
mesh (sharded or elastic) comes with the port's fleet.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod

FILE = "proc0.npz"  # one process, one device

# manifest dtype strings (numpy's names, as the JAX package writes them)
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _safe(key: str) -> str:
    return key.replace("/", "_").replace("[", "_").replace("]", "_").replace("'", "")


def _host_array(leaf: torch.Tensor) -> np.ndarray:
    """The leaf on the host as numpy (one device-to-host copy); bf16 as its
    16-bit pattern viewed as 2-byte void."""
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save(ckpt_dir: str, tree, *, step: int = 0, extra: Optional[Dict] = None) -> None:
    """Write ``tree`` (nested dicts, lists and NamedTuples of tensors) and
    ``step`` to ``ckpt_dir``, replacing a checkpoint there. The npz is
    written under a temporary name and renamed, the manifest last."""
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest: Dict[str, Any] = {"step": int(step), "leaves": {}, "extra": extra or {}}
    path = os.path.join(ckpt_dir, FILE)
    with zipfile.ZipFile(path + ".tmp", "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, leaf in tree_mod.leaves_with_keys(tree):
            if leaf is None:  # JAX's trees have no None leaves
                continue
            name = f"{_safe(key)}__c0"
            arr = _host_array(leaf)
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            manifest["leaves"][key] = {
                "shape": list(leaf.shape),
                "dtype": _NAMES[leaf.dtype],
                "chunks": [{"start": [0] * leaf.dim(), "shape": list(leaf.shape),
                            "file": FILE, "key": name}],
            }
            del arr
    os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _as_tensor(data: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:  # stored as 2-byte void (or any 16-bit view)
        return torch.from_numpy(np.asarray(data, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(data, order="C"))


@torch.no_grad()
def restore(ckpt_dir: str, template, *, mesh=None, specs=None) -> Tuple[Any, int]:
    """Restore ``ckpt_dir`` into ``template``'s tensors in place, leaf by
    leaf; returns (``template``, the saved step). Each leaf must have the
    saved shape and dtype. A checkpoint of several chunks a leaf (a sharded
    JAX run's) is assembled chunk by chunk. ``specs`` is only read with a
    mesh."""
    if mesh is not None:
        raise NotImplementedError(
            "restore onto a mesh (sharded or elastic) is not ported yet "
            "(ROADMAP queue 1, item 8: distributed)")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files: Dict[str, Any] = {}
    try:
        for key, leaf in tree_mod.leaves_with_keys(template):
            if leaf is None:
                continue
            meta = manifest["leaves"][key]
            dtype = _TORCH_DTYPES[meta["dtype"]]
            if list(leaf.shape) != meta["shape"] or leaf.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf {key} is {meta['dtype']} {meta['shape']}, the "
                    f"template's {_NAMES.get(leaf.dtype, leaf.dtype)} {list(leaf.shape)}")
            for c in meta["chunks"]:
                if c["file"] not in files:
                    files[c["file"]] = np.load(os.path.join(ckpt_dir, c["file"]))
                data = _as_tensor(files[c["file"]][c["key"]], dtype)
                region = tuple(slice(s, s + n) for s, n in zip(c["start"], c["shape"]))
                leaf[region].copy_(data)
                del data
    finally:
        for f in files.values():
            f.close()
    return template, manifest["step"]
