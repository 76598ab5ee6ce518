"""Checkpoints in the JAX launcher's npz layout.

One ``.npz`` of slash-joined keys: ``store/GROUP/NAME`` (the global
``(n_stack, tp, flat)`` arrays), ``opt/m/...``, ``opt/v/...``, ``opt/ef/...``
and ``opt/qef/...`` in the same layout (``qef`` at the full flat length a
data rank, so its last axis is ``fsdp * flat``), ``opt/step`` and
``meta/step``. A file written by either package restores in the other.

:func:`save` gathers every rank's shard over the data and model axes of
its mesh (the pods hold replicas; pod 0's are written) and rank 0 writes;
:func:`restore` gives each rank its ``(model, data)`` slice.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import all_gather_rows, all_gather_tiled
from repro_torch.parallel.axis import MeshAxes, axis_rank


def _global(t: torch.Tensor, mesh: MeshAxes) -> np.ndarray:
    """A rank's (n_stack, k) leaf -> the global (n_stack, tp, fsdp * k)
    array (on every rank of the pod)."""
    full = all_gather_tiled(t.detach(), mesh.data)          # (n, fsdp*k)
    rows = all_gather_rows(full, mesh.model)                # (tp, n, K)
    return rows.transpose(0, 1).cpu().numpy()


def _flatten(tree, prefix: str, mesh: MeshAxes, out: Dict) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", mesh, out)
    elif tree.dim() == 0:
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = _global(tree, mesh)


def save(path: str, store: Dict, opt_state: Optional[Dict] = None,
         step: int = 0, mesh: Optional[MeshAxes] = None) -> None:
    """Write ``store`` (and ``opt_state``) at ``step``; every rank of the
    mesh calls it, global rank 0 writes."""
    mesh = mesh or MeshAxes()
    flat: Dict[str, np.ndarray] = {}
    _flatten({"store": store}, "", mesh, flat)
    if opt_state is not None:
        _flatten({"opt": opt_state}, "", mesh, flat)
    flat["meta/step"] = np.asarray(step)
    pod = axis_rank(mesh.pod) if mesh.multi_pod else 0
    if pod or axis_rank(mesh.data) or axis_rank(mesh.model):
        return
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _slice(arr: np.ndarray, rank: int, data_rank: int, fsdp: int,
           device) -> torch.Tensor:
    """The (n_stack, k) leaf of (model ``rank``, data ``data_rank``) of a
    global (n_stack, tp, fsdp * k) array."""
    k = arr.shape[2] // fsdp
    vals = arr[:, rank, data_rank * k:(data_rank + 1) * k]
    return torch.from_numpy(np.ascontiguousarray(vals)).to(device)


def restore(path: str, device, rank: int = 0, data_rank: int = 0,
            fsdp: int = 1) -> Tuple[Dict, Optional[Dict], int]:
    """Read ``path`` -> (store, opt_state or None, step) of the rank at
    (model ``rank``, data ``data_rank``) of a mesh of data size ``fsdp``,
    on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("meta/step"))
    tree: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (torch.from_numpy(arr).to(device) if arr.ndim == 0
                           else _slice(arr, rank, data_rank, fsdp, device))
    return tree.get("store", {}), tree.get("opt"), step
