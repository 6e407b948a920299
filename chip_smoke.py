#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. card and build: the card's name and power limit, then the CUDA
     kernels built from ``src/repro_torch/csrc`` (one nvcc per source, in
     parallel), with the build seconds;
  2. kernel parity: each kernel (B1 bmf_precision, B2 bmf_sweep) against
     its plain PyTorch version, fp32 and bf16, at the phase-c bucket shape
     of phase 4's data (which holds all-padding tiles and empty rows),
     timed with CUDA events (warm-up, median of several runs);
  3. the quickstart on the card: ``mini``, ``run_full_bmf`` and a 2×2
     stacked ``run_pp`` with the fused sweep; PP must beat the mean
     predictor;
  4. the main path at full size: the MovieLens-20M shape of the paper's
     Table 1 (138,493 × 27,278, 144 ratings/row, K = 10, true rank 8), 10%
     held out, a 16×4 grid, and a stacked ``run_pp`` once with the fused
     sweep (B2) and once with the sufficient-statistics kernel (B1). Each
     run must give a finite RMSE below the mean predictor and launch its
     kernel;
  5. summary: one JSON line ``{"kernels": [...]}`` and, last, the
     ``{"ok": true, "device": {...}}`` line.

Without a GPU, or without the repository's ``src/repro_torch`` beside it,
it exits non-zero before printing any result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# kernel vs plain version on the card, relative to the largest plain
# value: both sum the same f32 products in other orders (up to thousands
# of slots per row); B2 also factors and solves in another order, which
# the conditional precision's condition number amplifies
TOL = {"bmf_precision": 1e-4, "bmf_sweep": 1e-4}

# the main path's chain, cut to fit the smoke's time limit
SAMPLES, BURNIN = 8, 3

TABLE1_MOVIELENS = dict(name="movielens-20m", n_rows=138_493, n_cols=27_278,
                        ratings_per_row=144, scale_lo=1, scale_hi=5, K=10,
                        true_rank=8)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, flops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from repro_torch.kernels import build as BUILD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.time()
    secs = BUILD.build()
    log(f"[build] {time.time() - t0:.1f}s wall; per source: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    for name in BUILD.SOURCES:
        lines = BUILD.lib_path(name).with_suffix(".log").read_text()
        regs = [ln.strip() for ln in lines.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + " | ".join(regs[:4]))


def make_data():
    from repro_torch.core.partition import partition, suggest_grid
    from repro_torch.data import synthetic as SYN
    from repro_torch.data.sparse import apply_permutation, train_test_split
    preset = SYN.DatasetPreset(**TABLE1_MOVIELENS)
    t0 = time.time()
    coo, _ = SYN.generate(preset, seed=0)
    train, test = train_test_split(coo, 0.1, seed=1)
    t1 = time.time()
    I, J = suggest_grid(train.n_rows, train.n_cols, 64)
    part = partition(train, I, J)
    t2 = time.time()
    log(f"[data] MovieLens-20M shape: {train.n_rows} x "
        f"{train.n_cols}, {train.nnz} train / {test.nnz} test ratings, "
        f"grid {I}x{J}; generate+split {t1 - t0:.1f}s, partition "
        f"{t2 - t1:.1f}s")
    test_p = apply_permutation(test, part.row_perm, part.col_perm)
    return preset, train, test, test_p, part


def phase_parity(part, test_p, K, dev):
    """B1 and B2 against their plain versions at the phase-c bucket."""
    import torch
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    from repro_torch.data.sparse import row_live
    from repro_torch.kernels.bmf_precision import ops as B1
    from repro_torch.kernels.bmf_precision.ref import precision_accum_plain
    from repro_torch.kernels.bmf_sweep import ops as B2
    from repro_torch.kernels.bmf_sweep.ref import sweep_ref_padded

    shapes = PP.BlockShapes.per_phase(part, test_p)
    s = shapes["c"]
    tasks = [t for _, ts in ENG.build_phase_graph(part) for t in ts
             if t.phase == "c"]
    buf = PP.new_block_inputs(s, K, len(tasks), dev, False, False)
    for b, t in enumerate(tasks):
        PP.fill_block_inputs(buf, b, part.block(t.i, t.j), s, test_p)
    idx, val, mask = buf["idx_r"], buf["val_r"], buf["mask_r"]
    del buf
    B, N, M = idx.shape
    D = s.n_cols
    live = row_live(mask)
    L = int(live.sum())
    n_empty = int((live == 0).sum())
    dead_tiles = int(((M + 31) // 32 - (live + 31) // 32).sum())
    log(f"[parity] phase-c bucket: B={B} N={N} M={M} D={D} K={K}; "
        f"{L} live slots, {n_empty} empty rows, {dead_tiles} all-padding "
        f"32-slot tiles skipped")
    assert n_empty > 0 and dead_tiles > 0

    g = torch.Generator(device=dev).manual_seed(0)
    other32 = torch.randn((B, D, K), generator=g, device=dev) / K ** 0.5
    A = torch.randn((B, N, K, K), generator=g, device=dev) * 0.2
    prior_lam = (A @ A.mT + 1.5 * torch.eye(K, device=dev)).contiguous()
    del A
    prior_eta = torch.randn((B, N, K), generator=g, device=dev) * 0.3
    z = torch.randn((B, N, K), generator=g, device=dev)
    tau = 2.0
    results = {}
    for dtype in ("fp32", "bf16"):
        other = other32.to(torch.bfloat16) if dtype == "bf16" else other32
        elt = other.element_size()
        base_bytes = 12 * L + 4 * B * N + elt * B * D * K
        acc_flops = L * (2 * K * K + 3 * K)

        def b1():
            return B1.precision_accum(idx, val, mask, other, tau, live)

        def b1_plain():
            return precision_accum_plain(idx, val, mask, other.float(), tau,
                                         live)

        (lam, eta), (lam_p, eta_p) = b1(), b1_plain()
        err1 = max(float((lam - lam_p).abs().max()),
                   float((eta - eta_p).abs().max()))
        scale1 = max(float(lam_p.abs().max()), float(eta_p.abs().max()), 1.0)
        del lam, eta, lam_p, eta_p
        ms1, pms1 = cuda_ms(b1, 5), cuda_ms(b1_plain, 3, warmup=1)
        bnd1 = bound(base_bytes + 4 * B * N * (K * K + K),
                     acc_flops + B * N * (K * K + K))

        def b2():
            return B2.fused_sweep(z, idx, val, mask, prior_eta, prior_lam,
                                  other, tau, dtype=dtype, live=live)

        def b2_plain():
            return sweep_ref_padded(idx, val, mask, prior_eta, prior_lam, z,
                                    other, tau, live=live)

        U, U_p = b2(), b2_plain()
        assert bool(torch.isfinite(U).all())
        err2 = float((U - U_p).abs().max())
        scale2 = max(float(U_p.abs().max()), 1.0)
        del U, U_p
        ms2, pms2 = cuda_ms(b2, 5), cuda_ms(b2_plain, 3, warmup=1)
        bnd2 = bound(base_bytes + 4 * B * N * (K * K + 3 * K),
                     acc_flops + B * N * (2 * K ** 3 // 3 + 5 * K * K))
        for name, err, sc, ms, pms, bd in (
                ("bmf_precision", err1, scale1, ms1, pms1, bnd1),
                ("bmf_sweep", err2, scale2, ms2, pms2, bnd2)):
            ok = err <= TOL[name] * sc
            log(f"[parity] {name} {dtype}: max_abs_err {err:.3e} (tolerance "
                f"{TOL[name]:.0e} x {sc:.3g} = {TOL[name] * sc:.3e}) "
                f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
            if not ok:
                raise AssertionError(f"{name} {dtype} disagrees with its "
                                     f"plain version")
            results[(name, dtype)] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=pms, bound_ms=bd[0],
                                          bound_by=bd[1])
    del idx, val, mask, live, other32, prior_lam, prior_eta, z
    torch.cuda.empty_cache()
    return results


def reset_counts():
    from repro_torch.kernels.bmf_precision import ops as B1
    from repro_torch.kernels.bmf_sweep import ops as B2
    B1.precision_accum.launches = 0
    B2.fused_sweep.launches = 0


def read_counts():
    from repro_torch.kernels.bmf_precision import ops as B1
    from repro_torch.kernels.bmf_sweep import ops as B2
    return {"bmf_precision": B1.precision_accum.launches,
            "bmf_sweep": B2.fused_sweep.launches}


def mean_rmse(train, test):
    import numpy as np
    return float(np.sqrt(np.mean((test.val - train.val.mean()) ** 2)))


def phase_quickstart(dev):
    from repro_torch.core import bmf as BMF
    from repro_torch.core import pp as PP
    from repro_torch.core.partition import partition
    from repro_torch.data import synthetic as SYN
    from repro_torch.data.sparse import train_test_split
    coo, preset = SYN.generate("mini", seed=0)
    train, test = train_test_split(coo, test_frac=0.15, seed=1)
    cfg = BMF.BMFConfig(K=preset.K, n_samples=50, burnin=20,
                        sweep_fused=True)
    reset_counts()
    rmse_bmf, secs, _ = PP.run_full_bmf(0, train, test, cfg, device=dev)
    res = PP.run_pp(1, partition(train, 2, 2), cfg, test,
                    executor="stacked", device=dev)
    counts = read_counts()
    base = mean_rmse(train, test)
    log(f"[quickstart] mean predictor {base:.4f}; full BMF {rmse_bmf:.4f} "
        f"({secs:.2f}s); PP 2x2 stacked {res.rmse:.4f} "
        f"({res.wall_time_s:.2f}s); launches {counts}")
    assert res.rmse < base, "PP must beat the mean predictor"
    assert counts["bmf_sweep"] > 0
    return counts


def phase_main(train, test, part, cfg, label, kernel, dev):
    import numpy as np
    import torch
    from repro_torch.core import engine as ENG
    from repro_torch.core import pp as PP
    ex = ENG.StackedExecutor()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = PP.run_pp(0, part, cfg, test, executor=ex, device=dev)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    base = mean_rmse(train, test)
    chain = ex.timings["chain_s"]
    log(f"[main:{label}] RMSE {res.rmse:.4f} (mean predictor {base:.4f}); "
        f"wall {res.wall_time_s:.2f}s, phases "
        + ", ".join(f"{k} {v:.2f}s" for k, v in res.phase_times_s.items())
        + f"; pad {ex.timings['pad_s']:.2f}s, chains {chain:.2f}s; "
        f"ratings/s {train.nnz * cfg.n_samples / chain:.4g} over the chains, "
        f"{train.nnz * cfg.n_samples / res.wall_time_s:.4g} over the wall; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    assert np.isfinite(res.rmse) and res.rmse < base, \
        f"{label}: RMSE {res.rmse} does not beat the mean predictor {base}"
    assert counts[kernel] > 0, f"{label}: {kernel} was never launched"
    assert not res.faults, f"{label}: health-guard faults {res.faults}"
    return counts


def main():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository's src/repro_torch beside "
              "it", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.core import bmf as BMF
    dev = resolve_device("cuda")

    phase_build()
    preset, train, test, test_p, part = make_data()
    K = preset.K
    parity = phase_parity(part, test_p, K, dev)
    phase_quickstart(dev)
    cfg = BMF.BMFConfig(K=K, n_samples=SAMPLES, burnin=BURNIN)
    launches = {}
    launches.update({"bmf_sweep": phase_main(
        train, test, part, cfg._replace(sweep_fused=True), "fused-sweep",
        "bmf_sweep", dev)["bmf_sweep"]})
    launches.update({"bmf_precision": phase_main(
        train, test, part, cfg._replace(use_kernel=True), "use-kernel",
        "bmf_precision", dev)["bmf_precision"]})

    meta = {
        "bmf_precision": dict(
            source="src/repro_torch/csrc/bmf_precision.cu",
            replaces="src/repro/kernels/bmf_precision/kernel.py:100"),
        "bmf_sweep": dict(
            source="src/repro_torch/csrc/bmf_sweep.cu",
            replaces="src/repro/kernels/bmf_sweep/kernel.py:232"),
    }
    kernels = []
    for name, m in meta.items():
        fp32, bf16 = parity[(name, "fp32")], parity[(name, "bf16")]
        kernels.append(dict(name=name, route="cuda", source=m["source"],
                            replaces=m["replaces"], launches=launches[name],
                            max_abs_err=fp32["max_abs_err"], ms=fp32["ms"],
                            plain_ms=fp32["plain_ms"],
                            bound_ms=fp32["bound_ms"],
                            bound_by=fp32["bound_by"], library_ms=None,
                            bf16=bf16))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
