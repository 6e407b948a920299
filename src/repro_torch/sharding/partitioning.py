"""Path-based partition specs for parameters, optimizer state, batches and
serving caches, and the placement of tensors on a mesh's slots (port of
``repro.sharding.partitioning``).

Mesh axes: ``('data', 'model')`` single-pod, ``('pod', 'data', 'model')``
multi-pod (``launch.mesh``). The ``pod`` axis extends data parallelism
across pods (the batch is sharded over ``('pod', 'data')``); ``model`` is
the tensor-parallel axis.

A spec is a plain tuple with one entry per dimension: None (replicated),
an axis name, or a tuple of axis names (the dimension split over their
product, the first name major), the counterpart of a ``PartitionSpec``.
The rules are the reference's, matched on the reference's pytree path of
each parameter (``ref_path``: ``blocks.<i>.attn.wq`` is row i of the
stacked ``blocks/attn/wq``). The port keeps one module per layer, so a
parameter's spec is the reference's spec of its stacked array without the
leading L axis, which no rule shards; ZeRO-1's choice of dimension
(``opt_specs``) is made on the stacked shape, as the reference makes it,
and then the L entry is dropped.

``place`` gives each slot its local shards (the counterpart of
``jax.device_put(x, NamedSharding(mesh, spec))``), ``gather`` puts them
back together, and ``Sharded`` holds one logical tensor as its slots'
shards for ``sharding.constraints.constrain``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape

Spec = Tuple[Any, ...]


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _divides(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# (regex on the reference's path suffix, spec WITHOUT the leading stacked-L
# axis); 'M' marks the model-sharded dim, 'F' (moe) an FSDP dim over 'data'
_PARAM_RULES = [
    # embeddings: vocab over model => logits come out vocab-sharded with no
    # extra collective on the (B, S, V) tensor
    (r"embed/table$", ("M", None)),
    (r"embed/unembed$", (None, "M")),
    # attention
    (r"(attn|self_attn|cross_attn)/wq$", (None, "M")),
    (r"(attn|self_attn|cross_attn)/wk$", (None, "M")),
    (r"(attn|self_attn|cross_attn)/wv$", (None, "M")),
    (r"(attn|self_attn|cross_attn)/wo$", ("M", None)),
    # dense mlp
    (r"mlp/w_gate$", (None, "M")),
    (r"mlp/w_up$", (None, "M")),
    (r"mlp/w_down$", ("M", None)),
    (r"mlp/w_in$", (None, "M")),
    (r"mlp/w_out$", ("M", None)),
    (r"mlp/b_in$", ("M",)),
    # moe (expert-parallel vs per-expert tensor-parallel decided below)
    (r"mlp/router$", (None, None)),
    (r"mlp/(w_gate|w_up)$", (None, None, "M")),   # placeholder; see below
    # rwkv6
    (r"att/(wr|wk|wv|wg)$", (None, "M")),
    (r"att/wo$", ("M", None)),
    (r"att/(decay_A|decay_B|decay_w0|bonus_u|mix_base)$", None),
    (r"ffn/w_in$", (None, "M")),
    (r"ffn/w_out$", ("M", None)),
    # mamba2
    (r"mixer/(w_z|w_x)$", (None, "M")),
    (r"mixer/w_dt$", (None, "M")),
    (r"mixer/(w_B|w_C)$", (None, None)),
    (r"mixer/conv_x$", (None, "M")),
    (r"mixer/conv_bias_x$", ("M",)),
    (r"mixer/(conv_B|conv_C|conv_bias_B|conv_bias_C)$", None),
    (r"mixer/(A_log|D|dt_bias)$", ("M",)),
    (r"mixer/norm/scale$", ("M",)),
    (r"mixer/out_proj$", ("M", None)),
]


def ref_path(name: str) -> Tuple[str, bool]:
    """(the reference's pytree path of ``CausalLM`` parameter ``name``,
    whether it is a row of a stacked (L, …) array): ``table`` and
    ``unembed`` live under ``embed``, ``blocks.<i>.<rest>`` (and
    ``enc_blocks.<i>.<rest>``) is row i of ``blocks/<rest>``."""
    parts = name.split(".")
    if parts[0] in ("table", "unembed"):
        return "embed/" + parts[0], False
    if parts[0] in ("blocks", "enc_blocks"):
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _spec_for_path(path: str, shape, cfg: ArchConfig, mesh) -> Spec:
    m_size = _axis_size(mesh, "model")
    # MoE expert weights: expert-parallel when E divides the model axis,
    # else tensor-parallel on the per-expert ffn dim + FSDP over 'data'
    # on d_model
    if re.search(r"mlp/(w_gate|w_up|w_down)$", path) and cfg.is_moe:
        if _divides(cfg.n_experts, m_size):
            spec = ("M", None, None)
        elif path.endswith("w_down"):
            spec = (None, "M", "F")
        else:
            spec = (None, "F", "M")
        return _materialize(spec, shape, mesh)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            return _materialize(spec, shape, mesh)
    # norms, scalars, biases: replicated
    return (None,) * len(shape)


def _materialize(spec, shape, mesh) -> Spec:
    """The rule's spec on ``shape``: a dim the axis does not divide stays
    unsharded; leading dims beyond the rule's stay unsharded."""
    if spec is None:
        return (None,) * len(shape)
    m_size = _axis_size(mesh, "model")
    d_size = _axis_size(mesh, "data")
    base = len(shape) - len(spec)
    out = [None] * base
    for j, s in enumerate(spec):
        dim = shape[base + j]
        if s == "M" and _divides(dim, m_size):
            out.append("model")
        elif s == "F" and _divides(dim, d_size):
            out.append("data")       # FSDP-style weight shard over data
        else:
            out.append(None)
    return tuple(out)


def _named_leaves(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    """The spec of every parameter of ``params`` (a ``CausalLM`` or a
    mapping of its parameter names to tensors), by name."""
    return {n: _spec_for_path(ref_path(n)[0], tuple(p.shape), cfg, mesh)
            for n, p in _named_leaves(params).items()}


def param_shardings(params, cfg: ArchConfig, mesh):
    return named(mesh, param_specs(params, cfg, mesh))


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------


def _n_stacked(cfg: ArchConfig, name: str) -> int:
    from repro_torch.models.model import n_stacked
    return n_stacked(cfg, name)


def opt_specs(opt_state, params, cfg: ArchConfig, mesh):
    """AdamWState(step, mu, nu) of specs: ZeRO-1, the moments shard like
    the parameters PLUS 'data' on the first still-unsharded dim that
    'data' divides and that is at least 64 × |data|, chosen on the
    reference's stacked shape (a layer axis it picks shards nothing in a
    per-layer parameter)."""
    ps = param_specs(params, cfg, mesh)
    d_size = _axis_size(mesh, "data")
    leaves = _named_leaves(params)

    def zero1(name):
        shape = tuple(leaves[name].shape)
        n = _n_stacked(cfg, name)
        lead = (n,) if n else ()
        names = ([None] * len(lead)) + list(ps[name])
        full = lead + shape
        if "data" not in names:
            for i, (a, dim) in enumerate(zip(names, full)):
                if a is None and _divides(dim, d_size) and dim >= d_size * 64:
                    names[i] = "data"
                    break
        return tuple(names[len(lead):])

    moments = {n: zero1(n) for n in leaves}
    return type(opt_state)(step=(), mu=moments, nu=dict(moments))


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def _batch_dim_axes(B: int, mesh):
    """Largest prefix of (pod, data) whose product divides B, as a
    ``PartitionSpec`` entry holds it (one name bare)."""
    axes = list(data_axes(mesh))
    total = 1
    for a in axes:
        total *= _axis_size(mesh, a)
    if _divides(B, total):
        return tuple(axes) if len(axes) > 1 else axes[0]
    if _divides(B, _axis_size(mesh, "data")):
        return "data"
    return None


def _map(fn, tree, path=""):
    """``fn(path, leaf)`` over a nested dict (paths joined with '/')."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def batch_specs(batch_tree, cfg: ArchConfig, shape: InputShape, mesh):
    """tokens (B, S) / *_embeds (B, T, d) sharded over the batch axes (a
    dict of tensors, or one tensor such as a decode step's tokens)."""
    def spec(_, leaf):
        return (_batch_dim_axes(leaf.shape[0], mesh),) + (None,) * (
            leaf.dim() - 1)
    return _map(spec, batch_tree)


def cache_specs(cache_tree, cfg: ArchConfig, shape: InputShape, mesh):
    """Serving cache sharding:

    - attention k/v (L, B, S, Hkv, hd): batch over data axes when divisible;
      'model' on the first of (Hkv, hd, S) it divides;
    - kv_pos (L, S) and the port's ``cross_pos`` (F,): replicated; ``pos``
      (a Python int) has the empty spec;
    - ssm/wkv/conv states: batch over data; heads/d_inner over model."""
    m = _axis_size(mesh, "model")

    def spec(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        shp = tuple(leaf.shape)
        if path.endswith("kv_pos") or path in ("pos", "cross_pos"):
            return (None,) * len(shp)
        if re.search(r"attn/(k_scale|v_scale)$", path):   # (L, B, S, Hkv)
            ba = _batch_dim_axes(shp[1], mesh)
            return (None, ba, None, "model" if _divides(shp[3], m) else None)
        if re.search(r"attn/(k|v)$", path) or re.search(r"cross_(k|v)$",
                                                        path):
            return kv_cache_spec(shp, mesh)
        if path.endswith("wkv"):                            # (L, B, H, N, N)
            ba = _batch_dim_axes(shp[1], mesh)
            return (None, ba, "model" if _divides(shp[2], m) else None,
                    None, None)
        if re.search(r"shift_(att|ffn)$", path):            # (L, B, d)
            ba = _batch_dim_axes(shp[1], mesh)
            return (None, ba, "model" if _divides(shp[2], m) else None)
        if re.search(r"mamba/(conv_x|conv_B|conv_C)$", path):  # (L,B,W-1,C)
            ba = _batch_dim_axes(shp[1], mesh)
            return (None, ba, None, "model" if _divides(shp[3], m) else None)
        if path.endswith("mamba/ssm"):                      # (L, B, H, P, N)
            ba = _batch_dim_axes(shp[1], mesh)
            return (None, ba, "model" if _divides(shp[2], m) else None,
                    None, None)
        ba = (_batch_dim_axes(shp[0], mesh) if len(shp) >= 1 and shp[0] > 1
              else None)
        return (ba,) + (None,) * (len(shp) - 1) if shp else ()

    return _map(spec, cache_tree)


def kv_cache_spec(shape, mesh) -> Spec:
    """The spec of an attention cache's k or v of ``shape`` (L, B, S, Hkv,
    hd): batch over the data axes when divisible, 'model' on the first
    of (Hkv, hd, S) it divides."""
    m = _axis_size(mesh, "model")
    _, B_, S_, H_, D_ = shape
    out = [None, _batch_dim_axes(B_, mesh), None, None, None]
    for dim, n in ((3, H_), (4, D_), (2, S_)):
        if _divides(n, m):
            out[dim] = "model"
            break
    return tuple(out)


def logits_spec(mesh, vocab: int) -> Spec:
    m = _axis_size(mesh, "model")
    return (None, None, "model" if _divides(vocab, m) else None)


# ---------------------------------------------------------------------------
# Shardings and placement
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _full(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard_slices(mesh, spec: Spec, shape, slot) -> Tuple[slice, ...]:
    """The index ranges of ``slot``'s shard of a ``shape`` tensor under
    ``spec``."""
    out = []
    for dim, entry in zip(shape, _full(spec, len(shape))):
        n = mesh.axis_size(_axes_of(entry)) if entry is not None else 1
        if dim % n:
            raise ValueError(f"spec {spec}: a dim of {dim} does not split "
                             f"into {n} shards")
        size = dim // n
        i = mesh.coord(slot, _axes_of(entry)) if entry is not None else 0
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_shape(mesh, spec: Spec, shape) -> Tuple[int, ...]:
    """One shard's shape (every slot's: the specs split evenly)."""
    return tuple(s.stop - s.start for s in
                 shard_slices(mesh, spec, shape, mesh.slots[0]))


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    def shard_shape(self, global_shape):
        return shard_shape(self.mesh, self.spec, tuple(global_shape))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def named(mesh, spec_tree):
    """``NamedSharding`` per spec of a tree of specs."""
    if _is_spec(spec_tree):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, Mapping):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    return spec_tree


def _tree_map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its tree of specs
    (nested dicts and NamedTuples; other leaves pass as they are)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map2(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map2(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return tree


def _local(t: torch.Tensor, spec: Spec, mesh, slot) -> torch.Tensor:
    dev = (mesh.device(slot) if mesh.devices is not None else t.device)
    shard = t.detach()[shard_slices(mesh, spec, tuple(t.shape), slot)]
    return shard.to(dev).clone(memory_format=torch.contiguous_format)


def place(tree, specs, mesh) -> Dict[tuple, Any]:
    """Each slot's local shards of ``tree`` under ``specs``, on the slot's
    device (a mesh without devices keeps the tensors' device, e.g.
    ``meta``): ``{slot: tree of shards}``, every shard its own contiguous
    copy, as each device of the reference's mesh holds its own. A
    ``CausalLM`` (``specs`` by parameter name, ``param_specs``) becomes one
    per slot, built from the shards with the same names, and with a
    gradient iff the original's parameters have one."""
    if isinstance(tree, torch.nn.Module):
        from repro_torch.models.model import build
        named_p = dict(tree.named_parameters())
        grad = any(p.requires_grad for p in named_p.values())
        out = {}
        for s in mesh.slots:
            shards = {n: _local(p, specs[n], mesh, s)
                      for n, p in named_p.items()}
            out[s] = build(tree.cfg, lambda n, _shape: shards[n]
                           ).requires_grad_(grad)
        return out
    return {s: _tree_map2(lambda t, sp: _local(t, sp, mesh, s), tree, specs)
            for s in mesh.slots}


def _assemble(parts, spec, mesh, device=None):
    """The whole tensor from every slot's shard (the replicated copies
    write the same values)."""
    first = parts[mesh.slots[0]]
    shape = []
    for d, entry in zip(first.shape, _full(spec, first.dim())):
        shape.append(d * (mesh.axis_size(_axes_of(entry))
                          if entry is not None else 1))
    dev = first.device if device is None else device
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    done = set()
    for s in mesh.slots:
        sl = shard_slices(mesh, spec, tuple(shape), s)
        key = tuple((x.start, x.stop) for x in sl)
        if key not in done:
            done.add(key)
            out[sl] = parts[s].detach().to(dev)
    return out


def gather(placed: Dict[tuple, Any], specs, mesh, device=None):
    """Whole tensors back from ``place``'s per-slot shards (on the first
    slot's device unless ``device`` names another): ``gather(place(x))``
    is ``x`` bitwise. Per-slot ``CausalLM``s give one ``CausalLM``."""
    first = placed[mesh.slots[0]]
    if isinstance(first, torch.nn.Module):
        from repro_torch.models.model import build
        names = [n for n, _ in first.named_parameters()]
        by_slot = {s: dict(m.named_parameters()) for s, m in placed.items()}
        whole = {n: _assemble({s: by_slot[s][n] for s in mesh.slots},
                              specs[n], mesh, device) for n in names}
        grad = any(p.requires_grad for p in by_slot[mesh.slots[0]].values())
        return build(first.cfg, lambda n, _shape: whole[n]
                     ).requires_grad_(grad)

    def walk(trees, spec):
        t0 = trees[mesh.slots[0]]
        if isinstance(t0, Mapping):
            return {k: walk({s: t[k] for s, t in trees.items()}, spec[k])
                    for k in t0}
        if hasattr(t0, "_fields"):
            return type(t0)(*(walk({s: t[i] for s, t in trees.items()}, sp)
                              for i, sp in enumerate(spec)))
        if isinstance(t0, torch.Tensor):
            return _assemble(trees, spec, mesh, device)
        return t0

    return walk(placed, specs)


@dataclass
class Sharded:
    """One logical tensor of global ``shape`` laid out over ``mesh`` by
    ``spec``: ``parts`` holds each slot's shard."""
    mesh: Any
    spec: Spec
    shape: Tuple[int, ...]
    parts: Dict[tuple, torch.Tensor]


def reshard(x: Sharded, spec: Spec) -> Sharded:
    """``x`` under ``spec``: a dim that loses (or changes) its axes is
    all-gathered over them, then a dim that gains axes is cut to the
    slot's range locally (no collective)."""
    mesh = x.mesh
    spec = _full(spec, len(x.shape))
    old = _full(x.spec, len(x.shape))
    parts = x.parts
    same = [_axes_of(a) == _axes_of(b) for a, b in zip(old, spec)]
    for i, (a, b) in enumerate(zip(old, spec)):
        if a is not None and not same[i]:
            parts = mesh.all_gather(parts, _axes_of(a), dim=i)
    for i, (a, b) in enumerate(zip(old, spec)):
        if b is not None and not same[i]:
            n = mesh.axis_size(_axes_of(b))
            size = x.shape[i] // n
            parts = {s: p.narrow(i, mesh.coord(s, _axes_of(b)) * size, size)
                     for s, p in parts.items()}
    return Sharded(mesh, spec, x.shape, parts)
