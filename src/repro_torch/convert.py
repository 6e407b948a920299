"""Carry state between the JAX reference and the port, as numpy arrays.

The reference's state types are NamedTuples (``RowGaussians``,
``GibbsAccumulators``, ``NormalWishart``, ``BMFConfig``) and the
``PaddedCSR`` dataclass; the port's have the same field names. The
``*_from_numpy`` functions build the port's objects from a mapping of
field name to numpy array (e.g. ``{k: np.asarray(v) for k, v in
jax_obj._asdict().items()}``) on a device; ``to_numpy`` turns any of the
port's objects back into nested dicts of numpy arrays. The LLM stack's
parameters (dense, moe, vlm, hybrid and ssm families; the moe family's
stacked experts as (L, E, …) arrays) travel as the reference's
``init_params`` pytree of numpy arrays (``llm_params_from_numpy`` /
``llm_params_to_numpy``), in the serving layout (the ``_cast_tree`` rule)
or the f32 training layout (dense, moe, vlm), and
so does AdamW's state (``adamw_state_from_numpy`` / ``adamw_state_to_numpy``:
``step``, ``mu``, ``nu`` with ``mu``/``nu`` in the parameters' tree). A
serving ``PosteriorStore`` travels as nested dicts of its fields
(``posterior_store_from_numpy`` / ``posterior_store_to_numpy``).
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.bmf import BMFConfig
from repro_torch.core.gibbs import GibbsAccumulators
from repro_torch.core.posterior import NormalWishart, RowGaussians
from repro_torch.data.sparse import PaddedCSR
from repro_torch.models import model as LM
from repro_torch.optim import adamw as ADAMW
from repro_torch.serving.store import PosteriorStore


def tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``; copies, so the
    source may be read-only."""
    arr = np.array(x, copy=True)
    return torch.from_numpy(arr).to(resolve_device(device), dtype=dtype)


def _named(cls, fields: Mapping[str, object], device):
    missing = [f for f in cls._fields if f not in fields]
    if missing:
        raise KeyError(f"{cls.__name__} needs fields {missing}")
    return cls(**{f: tensor(fields[f], device) for f in cls._fields})


def padded_csr_from_numpy(fields: Mapping[str, object],
                          device=None) -> PaddedCSR:
    """``fields``: idx (int32), val, mask (f32) planes and ``n_cols``."""
    dev = resolve_device(device)
    return PaddedCSR(idx=tensor(fields["idx"], dev, torch.int32),
                     val=tensor(fields["val"], dev, torch.float32),
                     mask=tensor(fields["mask"], dev, torch.float32),
                     n_cols=int(fields["n_cols"]))


def row_gaussians_from_numpy(fields, device=None) -> RowGaussians:
    return _named(RowGaussians, fields, device)


def accumulators_from_numpy(fields, device=None) -> GibbsAccumulators:
    return _named(GibbsAccumulators, fields, device)


def normal_wishart_from_numpy(fields, device=None) -> NormalWishart:
    return _named(NormalWishart, fields, device)


def factors_from_numpy(U, V, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return tensor(U, device, torch.float32), tensor(V, device, torch.float32)


def aggregates_from_numpy(U_agg, V_agg, device=None):
    """The ``U_agg`` / ``V_agg`` of a reference ``PPResult`` (each a
    mapping with eta and Lambda)."""
    return (row_gaussians_from_numpy(U_agg, device),
            row_gaussians_from_numpy(V_agg, device))


def posterior_store_from_numpy(fields: Mapping[str, Any],
                               device=None) -> PosteriorStore:
    """A reference ``PosteriorStore`` as numpy: ``U`` and ``V`` mappings
    with eta and Lambda, ``U_mean``, ``V_mean``, ``V_samples``, ``tau``."""
    dev = resolve_device(device)
    return PosteriorStore(
        U=row_gaussians_from_numpy(fields["U"], dev),
        V=row_gaussians_from_numpy(fields["V"], dev),
        **{f: tensor(fields[f], dev, torch.float32)
           for f in ("U_mean", "V_mean", "V_samples", "tau")})


def posterior_store_to_numpy(store: PosteriorStore) -> Dict[str, Any]:
    """The inverse of ``posterior_store_from_numpy``."""
    return to_numpy(store)


def bmf_config_from_dict(fields: Mapping[str, object]) -> BMFConfig:
    """A ``BMFConfig`` from the reference's ``cfg._asdict()``; unknown
    fields raise, missing ones keep their defaults."""
    unknown = set(fields) - set(BMFConfig._fields)
    if unknown:
        raise KeyError(f"BMFConfig has no fields {sorted(unknown)}")
    return BMFConfig(**dict(fields))


def to_numpy(obj):
    """The port's state as numpy: tensors become arrays, NamedTuples and
    ``PaddedCSR`` become dicts of their fields, other values pass as they
    are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, PaddedCSR):
        return {"idx": to_numpy(obj.idx), "val": to_numpy(obj.val),
                "mask": to_numpy(obj.mask), "n_cols": obj.n_cols}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _tree_path(name: str):
    """(path in the reference's pytree, layer index or None) of one
    ``CausalLM`` parameter name: ``table``/``unembed`` live under
    ``embed``, ``blocks.<i>.<path>`` is row i of the stacked ``blocks``
    array at ``<path>``, any other name is its own path."""
    parts = name.split(".")
    if parts[0] in ("table", "unembed"):
        return ["embed", parts[0]], None
    if parts[0] == "blocks":
        return ["blocks"] + parts[2:], int(parts[1])
    return parts, None


def llm_params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                          device=None, *, train: bool = False
                          ) -> "LM.CausalLM":
    """The port's ``CausalLM`` from the reference's ``init_params`` pytree
    as numpy (``jax.tree.map(np.asarray, params)``) of a config of a ported
    family, whose ``blocks`` hold stacked (L, …) arrays. ``train``
    picks the storage as ``model.init_params`` does: f32 with gradient
    (dense, moe, vlm), or the serving cast without: the reference's
    ``_cast_tree`` rule (``model.serve_dtype``), an f32 array with
    ndim >= 2 and more than ``CAST_MIN_SIZE`` elements goes to
    ``cfg.dtype``, applied to the stacked arrays, as the reference applies
    it, before they are split per layer."""
    dev = resolve_device(device)
    LM.check_trainable(cfg, train)

    def param(name, shape):
        path, layer = _tree_path(name)
        node = tree
        for p in path:
            node = node[p]
        a = np.asarray(node)
        if layer is not None and a.shape[0] != cfg.n_layers:
            raise ValueError(f"{'/'.join(path)} has {a.shape[0]} layers, "
                             f"cfg {cfg.n_layers}")
        dtype = None
        if not train and a.dtype == np.float32:
            dtype = LM.serve_dtype(a.shape, cfg)
        if layer is not None:
            a = a[layer]
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        return tensor(a, dev, dtype)

    return LM.build(cfg, param).requires_grad_(train)


def _llm_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's pytree layout, with stacked (L, …) blocks, of one
    tensor per ``CausalLM`` parameter name, as f32 numpy arrays."""
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, t in named.items():
        path, layer = _tree_path(name)
        arr = t.detach().float().cpu().numpy()
        if layer is None:
            _put(tree, path, arr)
        else:
            stacked.setdefault(tuple(path), {})[layer] = arr
    for path, rows in stacked.items():
        _put(tree, list(path), np.stack([rows[i] for i in sorted(rows)]))
    return tree


def _put(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def llm_params_to_numpy(params: "LM.CausalLM") -> Dict[str, Any]:
    """The inverse of ``llm_params_from_numpy``: the reference's pytree
    layout with stacked (L, …) blocks, as f32 numpy arrays."""
    return _llm_tree(dict(params.named_parameters()))


def adamw_state_from_numpy(fields: Mapping[str, Any],
                           params: "LM.CausalLM") -> "ADAMW.AdamWState":
    """The port's ``AdamWState`` for ``params`` from the reference's
    ``AdamWState`` as numpy (``step`` and the ``mu``/``nu`` pytrees, each in
    the parameters' layout), f32 on the parameters' device."""
    dev = params.table.device

    def named(tree):
        m = llm_params_from_numpy(tree, params.cfg, dev, train=True)
        return {n: t.detach() for n, t in m.named_parameters()}

    mu, nu = named(fields["mu"]), named(fields["nu"])
    names = [n for n, _ in params.named_parameters()]
    if list(mu) != names:
        raise KeyError(f"state names {list(mu)} differ from the "
                       f"parameters' {names}")
    return ADAMW.AdamWState(step=int(np.asarray(fields["step"])), mu=mu,
                            nu=nu)


def adamw_state_to_numpy(state: "ADAMW.AdamWState",
                         params: "LM.CausalLM") -> Dict[str, Any]:
    """The inverse of ``adamw_state_from_numpy``: ``step`` (int32) and
    ``mu``/``nu`` in the reference's pytree layout, as f32 numpy."""
    return {"step": np.int32(state.step), "mu": _llm_tree(state.mu),
            "nu": _llm_tree(state.nu)}
