"""Dry run of the paper's own workload on the ``meta`` device (port of
``repro.launch.bmf_dryrun``): the distributed BMF Gibbs sweep at
real-Netflix scale over a 256-slot 'data' group, and the PP executors'
units of work, planned as op traces that allocate nothing.

Where the reference lowers and compiles each executable at abstract
shapes, the port runs the same call once on ``meta`` tensors: every op
keeps its shapes and no value exists; the kernels record the launches
they stand for (``kernels.*.ops._plan``). The traces give

  - the roofline terms on one H100 (``roofline.op_cost`` over the op
    records, ``roofline.analysis.terms_from``), where the reference uses
    a TPU v5e;
  - the collectives each group was asked for
    (``core.topology.record_collectives``), by the reference's kinds
    with the port's per-U-step ``broadcast`` of V under its own;
  - the live-bytes high-water mark on the device
    (``op_cost.peak_buffer_bytes``), in place of XLA's
    ``memory_analysis``, with whether it fits one H100's 80 GB.

Records (``variant``): ``paper_psum`` and ``scatter_v`` (one sweep of
``distributed.make_distributed_sweep``); with ``--pp-engine`` also
``pp_phase_c_sharded`` (the stacked phase-c bucket), two
``pp_phase_c_composed_2d`` ('scatter', 'gather'; the composed chain of
``distributed.run_gibbs_stacked_2d`` on each group of a ``Topology(block,
data)``), ``pp_block_async_donated`` (one block's chain) and
``pp_window_streaming_donated`` (one streaming chunk against the stacked
bucket). Every slot of a plan's topology is the one device, so a peak is
what one card running that placement as streams would hold.

The traced configuration is the one the card runs: kernel B2
(``sweep_fused``) up to ``SWEEP_K_MAX``, B1 plus the torch Cholesky and
solves above it, B1 in the distributed V-step. Flops and bytes of a
chain are one traced sweep's chain (initialisation, one kept sweep,
summaries) times ``chain_len``, as the reference multiplies its traced
chain.

  python -m repro_torch.launch.bmf_dryrun [--shards 256] [--k 100] \\
      [--pp-engine] [--device meta] [--out build/bmf_dryrun_results.json]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch import analysis as LINT
from repro_torch.core import bmf as BMF
from repro_torch.core import distributed as DIST
from repro_torch.core import gibbs as GIBBS
from repro_torch.core import posterior as POST
from repro_torch.core.topology import Topology
from repro_torch.data.sparse import PaddedCSR
from repro_torch.noise import GeneratorNoise
from repro_torch.roofline import analysis as ROOF
from repro_torch.roofline import op_cost as COST

OUT = Path(__file__).resolve().parents[3] / "build" / "bmf_dryrun_results.json"
N_TEST = 1024


def chain_config(K: int) -> BMF.BMFConfig:
    """What the card runs at this K: B2 up to ``SWEEP_K_MAX``, B1 and the
    torch factorization above."""
    from repro_torch.kernels.bmf_sweep.ops import SWEEP_K_MAX
    return BMF.BMFConfig(K=K, use_kernel=True, sweep_fused=K <= SWEEP_K_MAX)


def cols_budget(N: int, D: int, M: int) -> int:
    """The transposed side's padded slots per row, as the reference sizes
    them."""
    return max(8, (M * N // D // 8) * 8)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def fits(peak: float) -> bool:
    return peak <= ROOF.HBM_CAPACITY


def _memory(peak: int) -> Dict:
    return {"peak_bytes": int(peak), "fits_80gb": fits(peak)}


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def lower_sweep(n_shards: int, N: int, D: int, M: int, K: int,
                scatter_v: bool, device="meta") -> Dict:
    """One sweep of the data-sharded chain (``make_distributed_sweep``:
    'psum', or 'scatter' with ``scatter_v``) on a ``Topology(1,
    n_shards)``, at the padded dims the reference lowers; the shards'
    planes are made before the trace (the chain makes them once), the NW
    hyperpriors resampled (no propagated prior)."""
    S = n_shards
    N_pad, D_pad = _ceil_to(N, S), _ceil_to(D, S)
    M_c = cols_budget(N, D, M)
    cfg = chain_config(K)
    comm = "scatter" if scatter_v else "psum"
    dev = torch.device(device)
    grp = Topology(1, S, devices=(dev,) * S).slots(0)
    f32, i32 = torch.float32, torch.int32
    rows = PaddedCSR(_empty((1, N_pad, M), i32, dev),
                     _empty((1, N_pad, M), f32, dev),
                     _empty((1, N_pad, M), f32, dev), n_cols=D_pad)
    csrt = tuple(_empty((1, S, D_pad, M_c), dt, dev) for dt in (i32, f32, f32))
    shards = DIST.row_shards(rows, grp, N_pad)
    csrt_s = DIST._csrt_shards(csrt, grp, N_pad // S)
    U, V = _empty((1, N_pad, K), f32, dev), _empty((1, D_pad, K), f32, dev)
    noise = GeneratorNoise([0], dev)
    nw = POST.default_nw(K, device=dev)
    u_s, v_s = DIST.make_distributed_sweep(cfg, grp, noise, shards, N_pad,
                                           N_pad, D_pad, csrt_s, D_pad, comm)

    def one_sweep(U, V, shards, csrt_s):
        return GIBBS.sweep(noise, nw, 0, U, V, shards, csrt_s, N_pad, D_pad,
                           K, None, None, None, None, u_s, v_s)

    tc = GIBBS.traced_run(one_sweep, (U, V, shards, csrt_s), {}, 1, dev)
    costs = COST.op_cost(tc.ops)
    terms = ROOF.terms_from(costs, tc.collectives, S)
    analytic = (DIST.sweep_comm_bytes_scatter if scatter_v
                else DIST.sweep_comm_bytes)(D_pad, K)
    return {
        "variant": "scatter_v" if scatter_v else "paper_psum",
        "n_shards": S, "N": N, "D": D, "M": M, "K": K,
        "roofline": terms.as_dict(),
        "analytic_comm_bytes": analytic,
        "collectives": ROOF.collective_bytes(tc.collectives),
        "kernel_launches": _launches(tc),
        **_memory(tc.peak_bytes),
    }


def _launches(tc) -> Dict[str, int]:
    from repro_torch.analysis import optrace as OPT
    return OPT.kernel_counts(tc.ops)


def trace_bucket(cfg: BMF.BMFConfig, B: int, N: int, D: int, M: int,
                 M_c: int, *, prior_use: bool = False, sweeps: int = 1,
                 device="meta", n_test: int = N_TEST):
    """The stacked chain ``run_gibbs_stacked`` runs for a bucket of B
    phase-c blocks (both priors propagated; ``prior_use`` adds the
    streaming chunk's per-block flags), traced once on ``device``."""
    return GIBBS.trace_chain(cfg._replace(phase_bc_samples=None), N, D, M,
                             M_c, n_test, batch=B, prior_use=prior_use,
                             sweeps=sweeps, device=device)


def lower_pp_phase(n_blocks: int, N: int, D: int, M: int, K: int,
                   chain_len: int, device="meta") -> Dict:
    """The phase-c bucket: B = n_blocks interior blocks' stacked chain.
    Same-phase blocks never talk: intra-phase collective bytes are 0."""
    tc = trace_bucket(chain_config(K), n_blocks, N, D, M,
                      cols_budget(N, D, M), device=device)
    costs = COST.op_cost(tc.ops, mult=chain_len)
    coll = ROOF.collective_bytes(tc.collectives)
    intra = float(sum(v for k, v in coll.items() if not k.startswith("n_")))
    assert intra == 0.0, f"collectives inside a phase: {coll}"
    return {
        "variant": "pp_phase_c_sharded",
        "n_blocks": n_blocks, "N": N, "D": D, "M": M, "K": K,
        "chain_len": chain_len,
        "roofline": ROOF.terms_from(costs, tc.collectives,
                                    n_blocks).as_dict(),
        "collectives": coll,
        "intra_phase_collective_bytes": intra,
        "kernel_launches": _launches(tc),
        **_memory(tc.peak_bytes),
    }


def lower_pp_phase_2d(n_block: int, n_data: int, N: int, D: int, M: int,
                      K: int, chain_len: int, comm: str = "scatter",
                      device="meta") -> Dict:
    """The composed unit of a ``Topology(n_block, n_data)``: one phase-c
    block per group, each chain data-sharded over its group's slots
    (``run_gibbs_stacked_2d`` in ``comm`` mode). The recorded calls are
    enrolled in the analyzer's 'collective-confinement' pass, as the
    reference enrolls its HLO: each runs over one group's slots (confined
    to 'data'), none spans two groups ('block'), and each group keeps its
    mode's per-sweep budget."""
    dev = torch.device(device)
    topo = Topology(n_block, n_data, devices=(dev,) * (n_block * n_data))
    cfg = chain_config(K)
    M_c = cols_budget(N, D, M)
    groups = [(g, tuple(str(d) for d in topo.group(g)))
              for g in range(n_block)]
    costs, calls, per_group, peak, launches = COST.zero(), [], None, 0, {}
    for g in range(n_block):
        tc = DIST.trace_chain_2d(cfg, topo, N, D, M, M_c, N_TEST, batch=1,
                                 comm=comm, sweeps=1, group=g)
        COST._add(costs, COST.op_cost(tc.ops, mult=chain_len))
        violations = LINT.analyze(LINT.CommArtifact(
            label=f"pp_phase_c_composed_2d[{comm}] group {g}",
            calls=tc.collectives, sweeps=1, comm=comm,
            allowed_groups=groups))
        assert not violations, (
            "composed chain fails the collective lint:\n"
            + "\n".join(str(v) for v in violations))
        calls += tc.collectives
        per_group = per_group or ROOF.collective_counts(tc.collectives)
        peak = max(peak, tc.peak_bytes)
        for k, n in _launches(tc).items():
            launches[k] = launches.get(k, 0) + n
    group0 = [c for c in calls if c.group == 0]
    conf = ROOF.collectives_confined_to_groups(calls, groups)
    return {
        "variant": "pp_phase_c_composed_2d",
        "comm": comm,
        "topology": [n_block, n_data],
        "N": N, "D": D, "M": M, "K": K, "chain_len": chain_len,
        "roofline": ROOF.terms_from(costs, group0, n_block * n_data,
                                    coll_mult=chain_len).as_dict(),
        # one group's calls in one sweep: what each group runs, by kind
        "collectives": ROOF.collective_bytes(group0),
        "collective_axis_check": {
            "n_collectives": conf["n_collectives"],
            "n_confined_to_data_axis": conf["n_confined"],
            "n_crossing_block_axis": conf["n_crossing"],
            "per_group_per_sweep": per_group,
        },
        "kernel_launches": launches,
        **_memory(peak),
    }


def lower_pp_window(window: int, n_blocks: int, N: int, D: int, M: int,
                    K: int, chain_len: int, device="meta") -> Dict:
    """The streaming executor's unit of work — one window chunk: the
    stacked chain at batch W with per-block prior-use flags — against the
    whole bucket's stacked chain at B = n_blocks: the planned peaks
    (``peak_buffer_bytes``, the chain's inputs included) and their
    ratio. The chunk's peak scales with W, the bucket's with B."""
    cfg = chain_config(K)
    M_c = cols_budget(N, D, M)
    win = trace_bucket(cfg, window, N, D, M, M_c, prior_use=True,
                       device=device).peak_bytes
    bucket = trace_bucket(cfg, n_blocks, N, D, M, M_c,
                          device=device).peak_bytes
    return {
        "variant": "pp_window_streaming_donated",
        "window": window, "n_blocks": n_blocks,
        "N": N, "D": D, "M": M, "K": K, "chain_len": chain_len,
        "window_effective_peak_bytes": int(win),
        "stacked_bucket_effective_peak_bytes": int(bucket),
        "peak_ratio": float(win / max(bucket, 1)),
        "fits_80gb": fits(win),
        "stacked_bucket_fits_80gb": fits(bucket),
    }


def lower_pp_block_async(N: int, D: int, M: int, K: int, chain_len: int,
                         device="meta") -> Dict:
    """The async executor's unit: one phase-c block's chain at B = 1.
    There is no XLA donation: ``alias_bytes`` counts the input storages an
    output of the trace lives in (the factor steps allocate each new U
    and V, so none is expected), ``donated_input_bytes`` what the
    reference donates (planes, test ids, U0, V0)."""
    cfg = chain_config(K)
    M_c = cols_budget(N, D, M)
    tc = GIBBS.trace_chain(cfg._replace(phase_bc_samples=None), N, D, M,
                           M_c, N_TEST, sweeps=1, device=device)
    costs = COST.op_cost(tc.ops, mult=chain_len)
    coll = ROOF.collective_bytes(tc.collectives)
    donated = (12 * (N * M + D * M_c) + 2 * 4 * N_TEST + 4 * (N + D) * K)
    return {
        "variant": "pp_block_async_donated",
        "N": N, "D": D, "M": M, "K": K, "chain_len": chain_len,
        "roofline": ROOF.terms_from(costs, tc.collectives, 1).as_dict(),
        "collectives": coll,
        "intra_phase_collective_bytes": float(
            sum(v for k, v in coll.items() if not k.startswith("n_"))),
        "has_input_output_alias": tc.alias_bytes > 0,
        "alias_bytes": int(tc.alias_bytes),
        "donated_input_bytes": donated,
        "kernel_launches": _launches(tc),
        **_memory(tc.peak_bytes),
    }


def run(args) -> List[Dict]:
    """Every record ``main`` prints, in its order."""
    results = []
    for sv in (False, True):
        results.append(lower_sweep(args.shards, args.n, args.d, args.m,
                                   args.k, sv, args.device))
    if args.pp_engine:
        # a 5x5 grid of the same matrix -> 16 interior (phase-c) blocks
        n, d, m = args.n // 5 + 1, args.d // 5 + 1, max(8, args.m // 4)
        results.append(lower_pp_phase(16, n, d, m, args.k, args.samples,
                                      args.device))
        tb, td = args.topo
        for comm in ("scatter", "gather"):
            results.append(lower_pp_phase_2d(tb, td, n, d, m, args.k,
                                             args.samples, comm,
                                             args.device))
        results.append(lower_pp_block_async(n, d, m, args.k, args.samples,
                                            args.device))
        results.append(lower_pp_window(args.window, 16, n, d, m, args.k,
                                       args.samples, args.device))
    return results


def describe(rec: Dict) -> str:
    """The reference's line for a record, with the plan's peak."""
    v = rec["variant"]
    gb = lambda b: f"{b / 1e9:.1f} GB"                  # noqa: E731
    fit = lambda ok: "fits" if ok else "does not fit"  # noqa: E731
    mem = (f"; peak {gb(rec['peak_bytes'])} ({fit(rec['fits_80gb'])} "
           f"80 GB)" if "peak_bytes" in rec else "")
    if v in ("paper_psum", "scatter_v"):
        rf = rec["roofline"]
        return (f"{v:12s} compute={rf['compute_s']:.3e}s "
                f"memory={rf['memory_s']:.3e}s "
                f"collective={rf['collective_s']:.3e}s "
                f"dominant={rf['dominant']} (analytic comm "
                f"{rec['analytic_comm_bytes'] / 1e6:.0f} MB)" + mem)
    if v == "pp_phase_c_sharded":
        return (f"{v} blocks={rec['n_blocks']} intra-phase collective "
                f"bytes={rec['intra_phase_collective_bytes']:.0f} (phase "
                f"boundary is the only communication); dominant="
                f"{rec['roofline']['dominant']}" + mem)
    if v == "pp_phase_c_composed_2d":
        chk = rec["collective_axis_check"]
        tb, td = rec["topology"]
        return (f"{v}[{rec['comm']}] topology={tb}x{td} "
                f"collectives={chk['n_collectives']} "
                f"confined-to-'data'={chk['n_confined_to_data_axis']} "
                f"crossing-'block'={chk['n_crossing_block_axis']}; "
                f"dominant={rec['roofline']['dominant']}" + mem)
    if v == "pp_block_async_donated":
        return (f"{v} alias_bytes={rec['alias_bytes']} "
                f"donated={rec['donated_input_bytes'] / 1e6:.0f}MB "
                f"intra-phase collective bytes="
                f"{rec['intra_phase_collective_bytes']:.0f}; dominant="
                f"{rec['roofline']['dominant']}" + mem)
    return (f"{v} W={rec['window']} window peak="
            f"{rec['window_effective_peak_bytes'] / 1e6:.0f}MB vs stacked "
            f"bucket={rec['stacked_bucket_effective_peak_bytes'] / 1e6:.0f}"
            f"MB (x{rec['peak_ratio']:.2f}; window "
            f"{fit(rec['fits_80gb'])}, bucket "
            f"{fit(rec['stacked_bucket_fits_80gb'])} 80 GB)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    # real-Netflix dims; M = padded nnz/row budget after balance permutation
    ap.add_argument("--n", type=int, default=480_256)
    ap.add_argument("--d", type=int, default=17_792)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--pp-engine", action="store_true",
                    help="also plan the PP executors' units (16 interior "
                         "blocks of a 5x5 grid)")
    ap.add_argument("--samples", type=int, default=60,
                    help="chain length the --pp-engine flops and bytes "
                         "are scaled to")
    ap.add_argument("--window", type=int, default=4,
                    help="streaming window W planned by --pp-engine")
    ap.add_argument("--topo", type=int, nargs=2, default=(16, 16),
                    metavar=("BLOCK", "DATA"),
                    help="(block, data) topology of the composed unit "
                         "planned by --pp-engine")
    ap.add_argument("--device", default="meta",
                    help="device the plans are traced on (meta: shapes "
                         "only, nothing allocated)")
    ap.add_argument("--out", type=Path, default=OUT)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    t0 = time.time()
    results = run(args)
    for rec in results:
        print(describe(rec))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    print(f"-> {args.out} ({time.time() - t0:.1f}s on {args.device})")
    return results


if __name__ == "__main__":
    main()
