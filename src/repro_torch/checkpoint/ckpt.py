"""Host-side checkpointing: pytree <-> npz with a JSON manifest (port of
``repro.checkpoint.ckpt``).

A pytree here is nested dicts, lists and tuples of tensors (or numpy
arrays): model parameters, optimizer state, BMF posteriors. Leaves are
copied to the host; the on-disk layout is the reference's, so either
package reads what the other wrote.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _items(tree, prefix=()):
    """(path, leaf) pairs of a nested dict/list/tuple, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:   # npz has no bf16; the manifest
            leaf = leaf.float()            # keeps the dtype
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _items(tree)}


def save(path: str | Path, tree: Any, step: int = 0, extra: Dict = None):
    """``path``.npz holds the leaves under their '/'-joined key paths,
    ``path``.json the manifest (step, keys, shapes, dtypes, ``extra``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    dtypes = {k: str(v.dtype).replace("torch.", "")
              if isinstance(v, torch.Tensor) else str(np.asarray(v).dtype)
              for k, v in _items(tree)}
    np.savez(path.with_suffix(".npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        **(extra or {}),
    }
    path.with_suffix(".json").write_text(json.dumps(manifest, indent=1))


def restore(path: str | Path, like: Any) -> Any:
    """Restore into the structure of ``like``: every leaf shape-checked
    and cast to the like-leaf's dtype on its device (bf16 round-trips
    through the f32 npz storage)."""
    path = Path(path)
    with np.load(path.with_suffix(".npz")) as data:
        def build(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: build(v, prefix + (str(k),))
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                out = [build(v, prefix + (str(i),))
                       for i, v in enumerate(tree)]
                return type(tree)(*out) if hasattr(tree, "_fields") \
                    else type(tree)(out)
            key = "/".join(prefix)
            arr = data[key]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"checkpoint {path}: {key} has shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(tree.shape)}")
            if isinstance(tree, torch.Tensor):
                return torch.from_numpy(arr).to(device=tree.device,
                                                dtype=tree.dtype)
            return arr.astype(np.asarray(tree).dtype)
        return build(like)


def manifest(path: str | Path) -> Dict:
    return json.loads(Path(path).with_suffix(".json").read_text())


# ---------------------------------------------------------------------------
# Phase-graph (PP) block-level checkpoint store
# ---------------------------------------------------------------------------


def _atomic_savez(path: Path, **arrays):
    """npz write that is atomic under kill -9: write to a temp file in the
    same directory, fsync, then os.replace — a resume never observes a
    torn block file (it either exists complete or not at all)."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class PPCheckpoint:
    """Per-block posterior store behind the phase-graph engine's
    checkpoint/resume (``core.engine.run_phase_graph(resume_from=...)``).

    Layout (the reference's): one ``block_{i}_{j}.npz`` per resolved
    block holding the trimmed ``RowGaussians`` natural parameters
    (U_eta/U_Lambda/V_eta/V_Lambda), the block's test squared error
    ``sq`` and observation count ``n_obs``, plus a ``meta.json`` naming
    the run (grid, K, chain config, seed — not the executor: block
    posteriors are executor-independent). The resolved set IS the set of
    complete block files, each written atomically, so a run killed at any
    instant leaves a resumable directory.

    ``every`` batches writes: blocks are buffered and flushed every
    ``every``-th resolve (a kill loses at most ``every - 1`` resolved
    blocks, recomputed on resume). Posteriors are float32 end to end, so
    a save/load round trip is bitwise exact."""

    META = "meta.json"

    def __init__(self, directory: str | Path, every: int = 1):
        if int(every) < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {every}")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = int(every)
        self._pending: List[Tuple[Tuple[int, int], Dict[str, np.ndarray]]] = []

    def write_meta(self, meta: Dict):
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self.dir / self.META)

    def note(self, coord: Tuple[int, int], U_post, V_post,
             sq: float, n_obs: int):
        """Buffer one resolved block; flush every ``self.every`` notes.
        The posteriors are copied to the host here."""
        self._pending.append((coord, {
            "U_eta": _host(U_post.eta), "U_Lambda": _host(U_post.Lambda),
            "V_eta": _host(V_post.eta), "V_Lambda": _host(V_post.Lambda),
            "sq": np.float64(sq), "n_obs": np.int64(n_obs),
        }))
        if len(self._pending) >= self.every:
            self.flush()

    def flush(self):
        for (i, j), arrays in self._pending:
            _atomic_savez(self.dir / f"block_{i}_{j}.npz", **arrays)
        self._pending = []

    @staticmethod
    def read_meta(directory: str | Path) -> Dict:
        return json.loads((Path(directory) / PPCheckpoint.META).read_text())

    @staticmethod
    def load_blocks(directory: str | Path
                    ) -> Dict[Tuple[int, int], Dict[str, np.ndarray]]:
        """All complete block files: {(i, j): {U_eta, U_Lambda, V_eta,
        V_Lambda, sq, n_obs}} with numpy leaves."""
        out: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        for p in sorted(Path(directory).glob("block_*_*.npz")):
            _, i, j = p.stem.split("_")
            with np.load(p) as data:
                out[(int(i), int(j))] = {k: data[k] for k in data.files}
        return out
