"""LLM dry run on the ``meta`` device (port of ``repro.launch.dryrun``):
plan every (arch × input shape × mesh) without allocating anything.

Where the reference jits the train, prefill or decode step with the
shardings of ``repro.sharding.partitioning`` on the production mesh
(16 × 16 single-pod, 2 × 16 × 16 multi-pod) and lowers and compiles it,
the port runs the SPMD program of one slot (``models.sharded``) once on
``meta`` tensors at that slot's shard sizes (``partitioning.place`` on a
``Mesh.view``): the slots are uniform under these specs, so one slot's
program is every slot's. The plan records

  - the op trace (``analysis.optrace``), costed by ``roofline.op_cost``
    (the attention kernels L1, L2, L3 as their plain versions), into the
    roofline terms on one H100 per slot (``n_chips`` = the mesh's
    slots);
  - the collectives the slot takes part in, by kind with their bytes
    (``core.topology.record_collectives``);
  - the kernel launches per slot;
  - memory: argument, output and aliased bytes of the slot's step, and
    the planned peak (``op_cost.peak_buffer_bytes``), with whether it fits
    one H100's 80 GB.

Serving plans take the serving layout of the weights (``model.serve_dtype``,
what the card serves), training plans the f32 master weights and AdamW
state. Every family is planned; a ``--kv-quant`` decode plans the int8
cache's sharded decode, and is skipped, with a note, for a family that
has no int8 cache (``kvcache.QUANT_FAMILIES``). ``shape_supported``'s
skips are recorded as in the reference.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_4b --shape train_4k \\
      --mesh single [--out build/dryrun_results.json]
  python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.analysis import optrace as OPT
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      TrainConfig, get_config,
                                      shape_supported)
from repro_torch.core.topology import record_collectives
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as MODEL
from repro_torch.models.kvcache import QUANT_FAMILIES
from repro_torch.models import sharded as SHARDED
from repro_torch.models import steps as STEPS
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as ROOF
from repro_torch.roofline import op_cost as COST
from repro_torch.sharding import partitioning as PART

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "build"
               / "dryrun_results.json")
META = torch.device("meta")


def production_mesh(multi_pod: bool) -> Mesh:
    """The reference's production mesh without devices."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def serve_params_specs(cfg) -> MODEL.CausalLM:
    """``cfg``'s model on ``meta`` in the serving layout (the reference's
    ``_cast_tree`` rule, ``model.serve_dtype``)."""
    return MODEL.build(cfg, lambda name, shape: torch.empty(
        shape, dtype=MODEL.serve_dtype(shape, cfg, MODEL.n_stacked(cfg,
                                                                    name)),
        device=META)).requires_grad_(False)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _shard_bytes(batch, specs, mesh) -> int:
    """Bytes of one slot's shards of a (meta) batch."""
    out = 0
    for t, sp in zip(_tensors(batch), _tensors_specs(batch, specs)):
        n = 1
        for d in PART.shard_shape(mesh, sp, tuple(t.shape)):
            n *= d
        out += n * t.element_size()
    return out


def _tensors_specs(batch, specs):
    if isinstance(batch, dict):
        return [s for k in batch for s in _tensors_specs(batch[k], specs[k])]
    return [specs]


def plan(cfg, shape: InputShape, mesh: Mesh, kind: str,
         tcfg: Optional[TrainConfig] = None,
         window_override: Optional[int] = None, n_steps: int = 1,
         kv_quant: bool = False) -> Dict:
    """One slot's program of the sharded step of ``kind`` ("train",
    "prefill" or "decode": ``n_steps`` decode steps from an empty cache,
    an int8 one with ``kv_quant``) for ``shape`` on ``mesh``, traced on
    ``meta``: the record's measured parts (roofline terms per slot,
    collectives, launches, memory)."""
    view = mesh.view()
    t0 = time.time()
    if kind == "train":
        params = STEPS.params_specs(cfg).requires_grad_(True)
        specs = PART.param_specs(params, cfg, view)
        opt = adamw.init(dict(params.named_parameters()))
        p_loc = PART.place(params, specs, view)
        o_loc = PART.place(opt, PART.opt_specs(opt, params, cfg, view), view)
        batch = STEPS.batch_specs(cfg, shape)
        args = (p_loc, o_loc)
        step = SHARDED.make_sharded_train_step(cfg, tcfg, view)
        b_bytes = _shard_bytes(batch, PART.batch_specs(batch, cfg, shape,
                                                       view), view)

        def run():
            out = step(p_loc, o_loc, batch)
            return [out[0], out[1], out[2]]
    else:
        params = serve_params_specs(cfg)
        p_loc = PART.place(params, PART.param_specs(params, cfg, view), view)
        lm = SHARDED.ShardedLM(cfg, view)
        if kind == "prefill":
            batch = STEPS.batch_specs(cfg, shape)
            step = SHARDED.make_sharded_prefill_step(cfg, shape, view,
                                                     window_override)
            args = (p_loc,)

            def run():
                return list(step(p_loc, batch))
        else:
            batch = STEPS.decode_token_specs(shape)
            cache = lm.cache_init(shape.global_batch, shape.seq_len,
                                  window_override, device=META,
                                  kv_quant=kv_quant)
            step = SHARDED.make_sharded_serve_step(cfg, view,
                                                   window_override)
            args = (p_loc, cache)

            def run():
                out = None
                for _ in range(n_steps):
                    out = step(p_loc, cache, batch)
                return list(out)
        b_bytes = _shard_bytes(batch, PART.batch_specs(batch, cfg, shape,
                                                       view), view)
    inputs = _tensors(args)
    with OPT.record() as tr, record_collectives() as calls:
        outs = run()
    plan_s = time.time() - t0
    costs = COST.op_cost(tr.ops)
    terms = ROOF.terms_from(costs, calls, 1)
    outputs = _tensors(outs)
    return {
        "n_chips": mesh.size,
        "plan_s": plan_s,
        "memory": {
            "argument_size_in_bytes": COST.storage_bytes(inputs) + b_bytes,
            "output_size_in_bytes": COST.storage_bytes(outputs),
            "alias_size_in_bytes": COST.alias_bytes(inputs, outputs),
            "peak_bytes": COST.peak_buffer_bytes(tr, inputs),
            "fits_80gb": COST.peak_buffer_bytes(tr, inputs)
            <= ROOF.HBM_CAPACITY,
        },
        "roofline": terms.as_dict(),
        "bytes_unfused_upper": costs["bytes"],
        "dot_flops_frac": (costs["dot_flops"] / costs["flops"]
                           if costs["flops"] else 0.0),
        "collectives": ROOF.collective_bytes(calls),
        "kernel_launches": OPT.kernel_counts(tr.ops),
        "_calls": calls,
        "_terms": terms,
    }


def lower_one(arch_id: str, shape_name: str, multi_pod: bool,
              tcfg=None, verbose=True, extra_tags=None) -> Dict:
    """The record of one (arch, shape, mesh): the reference's keys where
    they exist (``memory``, ``roofline``, ``collectives``, ``params``,
    ``active_params``, ``model_flops_per_chip``, ``useful_flops_ratio``,
    ``tokens_per_step``, ``swa_variant``), ``plan_s`` in place of its
    lower and compile times, and ``kernel_launches`` per slot, on the
    production mesh (``plan`` takes any mesh)."""
    cfg = get_config(arch_id)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    head = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name}
    ok, note = shape_supported(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "note": note}
    kv_quant = bool(extra_tags and extra_tags.get("kv_quant")) and \
        shape.kind == "decode"
    if kv_quant and cfg.family not in QUANT_FAMILIES:
        rec = {**head, "status": "skipped",
               "note": f"the {cfg.family} family has no int8 cache (its "
                       f"reference decode reads one only for the "
                       f"{', '.join(QUANT_FAMILIES)} families)"}
        if extra_tags:
            rec.update(extra_tags)
        return rec
    # production default: 4 microbatches of 64 sequences
    tcfg = tcfg or TrainConfig(microbatches=4)
    mesh = production_mesh(multi_pod)
    win = STEPS.long_context_window(cfg, shape)
    kind = shape.kind
    p = plan(cfg, shape, mesh, kind, tcfg, win, kv_quant=kv_quant)
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    n_active = cfg.active_param_count()
    mf = ROOF.model_flops_per_step(n_active, tokens, kind) / mesh.size
    flops = p["_terms"].flops
    rec = {
        **head, "status": "ok", "kind": kind, "swa_variant": bool(win),
        "mesh_shape": dict(mesh.shape), "n_chips": p["n_chips"],
        "plan_s": round(p["plan_s"], 2), "memory": p["memory"],
        "roofline": p["roofline"],
        "bytes_unfused_upper": p["bytes_unfused_upper"],
        "dot_flops_frac": p["dot_flops_frac"],
        "collectives": p["collectives"],
        "kernel_launches": p["kernel_launches"],
        "params": cfg.param_count(), "active_params": n_active,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": (mf / flops) if flops else 0.0,
        "tokens_per_step": tokens,
    }
    if extra_tags:
        rec.update(extra_tags)
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "status", "plan_s")}))
        print("  memory:", rec["memory"])
        print("  roofline:", {k: (f"{v:.3e}" if isinstance(v, float) else v)
                              for k, v in rec["roofline"].items()})
        print("  collectives:", {k: v for k, v in rec["collectives"].items()
                                 if v})
        print("  launches per slot:", rec["kernel_launches"])
    return rec


def append_result(rec, out_path: Path):
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())
    # replace the same-key entry if present
    key = (rec["arch"], rec["shape"], rec["mesh"], rec.get("tag", ""))
    results = [r for r in results
               if (r["arch"], r["shape"], r["mesh"], r.get("tag", "")) != key]
    results.append(rec)
    out_path.write_text(json.dumps(results, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--tag", default="")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode shapes")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        combos = [(a, s, m) for a in ARCH_IDS for s in INPUT_SHAPES
                  for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        combos = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    extra = {"kv_quant": True} if args.kv_quant else None
    for a, s, m in combos:
        try:
            rec = lower_one(a, s, m, extra_tags=extra)
        except Exception:
            failures += 1
            rec = {"arch": a, "shape": s, "mesh": "multi" if m else "single",
                   "status": "error", "error": traceback.format_exc()[-2000:]}
            print(f"FAILED {a} {s} mesh={'multi' if m else 'single'}",
                  file=sys.stderr)
            print(rec["error"], file=sys.stderr)
        if args.tag:
            rec["tag"] = args.tag
        append_result(rec, Path(args.out))
    print(f"-> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
