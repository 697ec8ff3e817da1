"""Checkpoint and resume for MCMC runs (port of ``openmcmc_tpu/checkpoint.py``).

A result's sampling carry -- the final chain states, the sampler statistics and
``final_key``, the seed the chains continue on -- is a complete checkpoint:
with ``MCMC.run(resume=...)`` it gives crash recovery and incremental long runs.

The file is a numpy ``.npz`` with the JAX package's layout: nested dicts
flattened to "a/b/c" paths, and an empty dict (a conjugate sampler's
statistics) recorded by the ``__empty_dict__`` sentinel. Tensors pass through
numpy on the host and come back on the ``device`` :func:`load_checkpoint` is
given. ``final_key`` is one integer, where the JAX package stores (n_chains, 2)
threefry keys, so a checkpoint of one package does not resume in the other.
There is no orbax directory format: a path that does not end in ``.npz``
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from openmcmc_tpu_torch.mcmc import MCMCResult

_EMPTY = "__empty_dict__"


def check_path(path: str) -> None:
    """Raise unless ``path`` names an ``.npz`` file."""
    if not str(path).endswith(".npz"):
        raise ValueError(f"checkpoint path {path!r}: the port writes .npz files only (the JAX package's orbax "
                         "directory format is not ported); give a path ending in .npz")


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix + _EMPTY] = np.zeros(())
            return out
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
    return out


def _unflatten(flat: dict, device) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != _EMPTY:
            node[parts[-1]] = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return tree


def save_checkpoint(path: str, result: MCMCResult, include_store: bool = False) -> None:
    """Write a result's sampling carry (and, with ``include_store``, its stored
    draws and log_post, which can be large) to the ``.npz`` file ``path``."""
    check_path(path)
    payload = {"final_state": result.final_state, "final_key": np.int64(result.final_key), "stats": result.stats}
    if include_store:
        payload["store"] = result.store
        payload["log_post"] = result.log_post
    np.savez(path, **_flatten(payload))


def load_checkpoint(path: str, device="cuda") -> MCMCResult:
    """Restore a checkpoint as an MCMCResult for ``MCMC.run(resume=...)``, its
    tensors on ``device`` (the card unless the caller asks for the CPU). The
    store and log_post are empty unless it was saved with include_store."""
    check_path(path)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    final_key = int(flat.pop("final_key"))
    payload = _unflatten(flat, torch.device(device))
    return MCMCResult(
        store=payload.get("store", {}),
        log_post=payload.get("log_post", torch.zeros((), device=device)),
        stats=payload.get("stats", {}),
        final_state=payload["final_state"],
        final_key=final_key,
    )
