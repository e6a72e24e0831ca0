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
survives and the peak stays at one state plus one leaf.

On a rank mesh each rank saves its own shards (``proc<r>.npz``, the JAX
package's multi-process layout) and restores its own region of each leaf
from whatever chunks overlap it, so a checkpoint of one mesh restores onto
any other (elastic restart).
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


def save(ckpt_dir: str, tree, *, step: int = 0, extra: Optional[Dict] = None,
         mesh=None, specs=None) -> None:
    """Write ``tree`` (nested dicts, lists and NamedTuples of tensors) and
    ``step`` to ``ckpt_dir``, replacing a checkpoint there. The npz is
    written under a temporary name and renamed, the manifest last.

    On a rank mesh (``mesh`` with a world, ``specs`` a tree of specs like
    ``tree``'s) each leaf is this rank's shard: rank r writes
    ``proc<r>.npz`` with the shards it is the lowest rank to hold, at their
    global offsets, and rank 0 the manifest of every rank's chunks, after
    the others have written theirs."""
    os.makedirs(ckpt_dir, exist_ok=True)
    ranked = mesh is not None and mesh.torch_mesh is not None
    rank = mesh.rank if ranked else 0
    fname = f"proc{rank}.npz" if ranked else FILE
    spec_list = None
    if ranked:
        from repro_torch.distributed import sharding as shr

        spec_list = shr.spec_leaves(specs, tree)
    manifest: Dict[str, Any] = {"step": int(step), "leaves": {}, "extra": extra or {}}
    path = os.path.join(ckpt_dir, fname)
    with zipfile.ZipFile(path + ".tmp", "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (key, leaf) in enumerate(tree_mod.leaves_with_keys(tree)):
            if leaf is None:  # JAX's trees have no None leaves
                continue
            chunks = [(0, [0] * leaf.dim(), list(leaf.shape), FILE)]
            shape = list(leaf.shape)
            if ranked:
                chunks, shape = _rank_chunks(mesh, leaf, spec_list[i])
            for owner, start, cshape, cfile in chunks:
                name = f"{_safe(key)}__c{owner}"
                if owner == rank:
                    arr = _host_array(leaf)
                    with zf.open(name + ".npy", "w", force_zip64=True) as f:
                        np.lib.format.write_array(f, arr, allow_pickle=False)
                    del arr
            manifest["leaves"][key] = {
                "shape": shape,
                "dtype": _NAMES[leaf.dtype],
                "chunks": [{"start": start, "shape": cshape, "file": cfile,
                            "key": f"{_safe(key)}__c{owner}"}
                           for owner, start, cshape, cfile in chunks],
            }
    os.replace(path + ".tmp", path)
    if ranked:
        import torch.distributed as dist

        dist.barrier()
        if rank != 0:
            return
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _rank_chunks(mesh, leaf, spec):
    """(owner rank, start, shape, file) of each distinct region of a leaf
    split under ``spec`` over a rank mesh, the owner the lowest rank that
    holds it; and the leaf's global shape."""
    from repro_torch.core.databuffer import rank_coords
    from repro_torch.distributed import collectives

    shape = list(collectives.global_shape(mesh, leaf.shape, spec))
    seen, chunks = set(), []
    for r in range(mesh.num_ranks):
        reg = collectives.region(mesh, shape, spec, rank_coords(mesh.shape, r))
        start = tuple(sl.start for sl in reg)
        if start in seen:
            continue
        seen.add(start)
        chunks.append((r, list(start), [sl.stop - sl.start for sl in reg], f"proc{r}.npz"))
    return chunks, shape


def _as_tensor(data: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:  # stored as 2-byte void (or any 16-bit view)
        return torch.from_numpy(np.asarray(data, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(data, order="C"))


@torch.no_grad()
def restore(ckpt_dir: str, template, *, mesh=None, specs=None) -> Tuple[Any, int]:
    """Restore ``ckpt_dir`` into ``template``'s tensors in place, leaf by
    leaf; returns (``template``, the saved step). A checkpoint of several
    chunks a leaf (a sharded JAX run's) is assembled chunk by chunk.

    Without ``mesh`` each template leaf takes the whole saved leaf (its
    shape and dtype must be the saved ones). With ``mesh`` and ``specs``
    (a tree of specs like ``template``'s; None: whole) the restore is
    elastic: each template leaf is this rank's shard under its spec, and
    only the chunks that overlap the shard's region of the saved leaf are
    read, whatever mesh wrote them."""
    spec_of = None
    if mesh is not None:
        from repro_torch.distributed import sharding as shr

        spec_list = (shr.spec_leaves(specs, template) if specs is not None
                     else [None] * len(tree_mod.leaves(template)))
        spec_of = dict(zip((k for k, _ in tree_mod.leaves_with_keys(template)), spec_list))
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files: Dict[str, Any] = {}
    try:
        for key, leaf in tree_mod.leaves_with_keys(template):
            if leaf is None:
                continue
            meta = manifest["leaves"][key]
            dtype = _TORCH_DTYPES[meta["dtype"]]
            want = tuple(slice(0, n) for n in meta["shape"])
            if spec_of is not None:
                from repro_torch.distributed import collectives

                want = collectives.region(mesh, meta["shape"], spec_of[key])
            if [w.stop - w.start for w in want] != list(leaf.shape) or leaf.dtype != dtype:
                raise ValueError(
                    f"checkpoint leaf {key} is {meta['dtype']} {meta['shape']} (this rank's "
                    f"region {[w.stop - w.start for w in want]}), the template's "
                    f"{_NAMES.get(leaf.dtype, leaf.dtype)} {list(leaf.shape)}")
            for c in meta["chunks"]:
                have = tuple(slice(s, s + n) for s, n in zip(c["start"], c["shape"]))
                both = tuple(slice(max(h.start, w.start), min(h.stop, w.stop))
                             for h, w in zip(have, want))
                if any(b.start >= b.stop for b in both) and leaf.dim():
                    continue  # no overlap with this rank's region
                if c["file"] not in files:
                    files[c["file"]] = np.load(os.path.join(ckpt_dir, c["file"]))
                data = _as_tensor(files[c["file"]][c["key"]], dtype)
                src = tuple(slice(b.start - h.start, b.stop - h.start) for b, h in zip(both, have))
                dst = tuple(slice(b.start - w.start, b.stop - w.start) for b, w in zip(both, want))
                leaf[dst].copy_(data[src])
                del data
    finally:
        for f in files.values():
            f.close()
    return template, manifest["step"]
