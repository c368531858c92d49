"""The SPE10 north star on the card: the structured spectral Hdiv-L2
setup lanes of the JAX bench (bench.py::lane_spe10_structured and
::lane_spe10_ml), on amge/structured_spectral.py and
amge/structured_spectral_ml.py.

    python -m parelag_tpu_torch.spectral_lane --cells 30,55,21 [--full]
        [--ml 32,32,16] [--device cpu] [--profile] [--out F]

spe10_structured: one spectral coarsening of the synthetic SPE10-like
field (models.spe10.synthetic_spe10_field, seed 0; the coefficient is
the mean of the inverse permeability's three components per cell) with
per-axis factors _pick_factors(cells) (the divisor of each extent
nearest 4: (4, 4, 5) on the full SPE10 grid (60, 220, 85)), spect_tol
0.002 and 5 eigenvectors, in f64 with direct batched solves and f64
eigh/svd on the device.  (The JAX lane runs f32 only because of the TPU,
bench.py:1150-1151; its host anchor is f64.)  spe10_ml: the two-step
block chain at (32, 32, 16) with factors (4, 4, 2), (2, 2, 2) and 4
eigenvectors, also in f64: in f32 its extension stage's relative
residual (8.9e-4 on the CPU) fails the 5e-4 guard.

Each lane prints one JSON line with the JAX bench's fields (cells,
factors, ndofs_u, coarse_u, coarse_p, setup_s, value in dof/s, u_l2_rel
where computed) and the port's own: dtype, the seconds of each stage,
the stage residuals, ext_spot_err, the keep-threshold margins and the
card's peak memory.  setup_s is CUDA events around the whole setup on
the card (host stages included), the host clock on the CPU.  At the full
grid the record carries the JAX package's host f64 anchor from
.bench_anchors.json (a host CPU time of the same engine, not a card
time).  --profile traces each lane with torch.profiler and adds the
device time of its top kernels by name (which cuSOLVER and cuBLAS
routines the batched linalg ran).
"""

import argparse
import json
import os
import subprocess

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.amge import structured as stc
from parelag_tpu_torch.amge import structured_spectral as sps
from parelag_tpu_torch.amge import structured_spectral_ml as ml
from parelag_tpu_torch.darcy_lane import _timed
from parelag_tpu_torch.models.spe10 import synthetic_spe10_field

#: the JAX bench's structured SPE10 grids and its multilevel lane
CELLS, FULL, ML_CELLS = (30, 55, 21), (60, 220, 85), (32, 32, 16)
ML_FACTORS = ((4, 4, 2), (2, 2, 2))
#: the fine saddle solve behind u_l2_rel runs by default up to this many
#: cells (bench.py::lane_spe10_structured's rule)
U_L2_CELLS = 20_000
ANCHORS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_anchors.json")


def _pick_factors(cells, target=4):
    """Per-axis cartesian coarsening factor: the divisor of each
    extent closest to `target` (SPE10's 85 has no factor 4 — picks 5)."""
    out = []
    for n in cells:
        divs = [d for d in range(2, min(n, 8) + 1) if n % d == 0]
        out.append(min(divs, key=lambda d: abs(d - target))
                   if divs else 1)
    return tuple(out)


def spe10_coeff(cells):
    """(field, per-cell Hdiv coefficient) of the synthetic SPE10-like
    field on `cells` (seed 0), in the structured engine's cell order."""
    field = synthetic_spe10_field(tuple(cells), seed=0)
    return field, field.inv_perm.mean(-1).transpose(2, 1, 0).ravel()


def fine_darcy(cells, coeff, h, rtol=1e-13):
    """The fine mixed Darcy problem of the upscaling check (unit source,
    natural BC): (M2, W, B, uf) with uf its fine velocity.  The saddle
    [[M2, B^T], [B, 0]] is solved through its Schur complement
    S = B M2^-1 B^T by CG to rtol (preconditioned by diag(B diag(M2)^-1
    B^T), M2^-1 by a sparse LU): a sparse direct solve of the whole
    saddle, bench.py's route below 20,000 cells, took ~500 s at
    (30, 55, 21) on one CPU core."""
    nc, nf, _, _ = stc.grid_counts(cells)
    ref = stc.fine_local_masses(h)
    M2 = stc.assemble_global(
        coeff[:, None, None] * ref[(0, 2)][None],
        stc.cell_faces(cells), sum(nf))
    W = sp.diags(np.full(nc, float(ref[(0, 3)][0, 0]))).tocsr()
    _, _, d2 = stc.fine_derivative_values(cells, h)
    D2 = stc.assemble_d_csr(d2, stc.d2_cols(cells), (nc, sum(nf)))
    B = (W @ D2).tocsr()
    lu = spla.splu(sp.csc_matrix(M2), permc_spec="MMD_AT_PLUS_A",
                   diag_pivot_thresh=0.0)
    dinv = 1.0 / np.asarray(B.multiply(B) @ (1.0 / M2.diagonal())).ravel()
    g = -W.diagonal()                  # S p = -g_p, u = -M2^-1 B^T p
    p = np.zeros(nc)
    r = g.copy()
    z = dinv * r
    d = z.copy()
    rz = r @ z
    nrm = np.linalg.norm(g)
    for _ in range(20 * nc):
        if np.linalg.norm(r) <= rtol * nrm:
            break
        Sd = B @ lu.solve(B.T @ d)
        alpha = rz / (d @ Sd)
        p += alpha * d
        r -= alpha * Sd
        z = dinv * r
        rz, rz_old = r @ z, rz
        d = z + (rz / rz_old) * d
    else:
        raise RuntimeError("the fine Darcy Schur-complement CG did not "
                           f"reach rtol {rtol}")
    return M2, W, B, -lu.solve(B.T @ p)


def upscaling_error(fine, P2, P3):
    """u_l2_rel of bench.py::lane_spe10_structured: the Galerkin-coarse
    solve of the fine problem through (P2, P3), interpolated, against the
    fine velocity in the M2 norm."""
    M2, W, B, uf = fine
    P2, P3 = P2.astype(np.float64), P3.astype(np.float64)
    Ac = sp.bmat([[(P2.T @ M2 @ P2), (P3.T @ B @ P2).T],
                  [(P3.T @ B @ P2), None]], format="csc")
    xc = spla.spsolve(Ac, np.concatenate(
        [np.zeros(P2.shape[1]), P3.T @ W.diagonal()]))
    du = P2 @ xc[:P2.shape[1]] - uf
    return float(np.sqrt(du @ (M2 @ du)) / np.sqrt(uf @ (M2 @ uf)))


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    """Peak card memory since _reset_peak (None on the CPU)."""
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)


def host_anchor(cells):
    """The JAX package's host f64 anchor of the structured engine on
    `cells` from .bench_anchors.json, or None."""
    if not os.path.exists(ANCHORS):
        return None
    with open(ANCHORS) as f:
        return json.load(f).get(f"spe10_structured_host_{tuple(cells)}")


def lane_spe10_structured(cells=CELLS, spect_tol=0.002, max_evects=5,
                          device=None, u_l2=None, fine=None):
    """The spe10_structured record on `device` (None: the card).  u_l2:
    compute u_l2_rel (default: at <= U_L2_CELLS cells); fine: a
    fine_darcy() of the same cells to reuse.  Returns (record,
    SpectralDarcyOut)."""
    device = resolve_device(device)
    cells = tuple(cells)
    field, coeff = spe10_coeff(cells)
    f = _pick_factors(cells)
    _reset_peak(device)
    out, setup_s, _ = _timed(lambda: sps.spectral_coarsen_darcy(
        cells, f, coeff, h=field.sizes, spect_tol=spect_tol,
        max_evects=max_evects, dtype=np.float64, device=device), device)
    nu = int(out.P2.shape[0])
    rec = dict(metric="spe10_structured_spectral_setup", cells=list(cells),
               factors=list(f), mode="direct", dtype="float64", ndofs_u=nu,
               coarse_u=int(out.P2.shape[1]),
               coarse_p=int(out.P3.shape[1]), setup_s=setup_s,
               value=nu / setup_s, unit="dof_per_s", stage_s=out.stage_s,
               stage_res=out.stage_res, ns_res=out.ns_res,
               ext_spot_err=out.ext_spot_err, min_margin=out.min_margin,
               near_threshold={k: len(v) for k, v in
                               out.near_threshold.items()},
               peak_mem_bytes=_peak(device), device=str(device))
    if u_l2 is None:
        u_l2 = int(np.prod(cells)) <= U_L2_CELLS
    if u_l2:
        fine = fine or fine_darcy(cells, coeff, field.sizes)
        rec["u_l2_rel"] = upscaling_error(fine, out.P2, out.P3)
    anchor = host_anchor(cells)
    if anchor is not None:
        rec.update(host_anchor_setup_s=anchor["setup_s"],
                   host_anchor_kind=anchor["kind"],
                   host_anchor_measured_utc=anchor["measured_utc"],
                   host_anchor_ndofs_u=anchor["ndofs_u"],
                   host_anchor_coarse_u=anchor["coarse_u"])
    return rec, out


def lane_spe10_ml(cells=ML_CELLS, facs=ML_FACTORS, spect_tol=0.002,
                  max_evects=4, device=None, u_l2=True, fine=None):
    """The spe10_ml record on `device` (None: the card): the block chain
    in f64; u_l2_rel through the composed prolongations of the last
    level (fine: a fine_darcy() of the same cells to reuse).  Returns
    (record, (levels, outs))."""
    device = resolve_device(device)
    cells = tuple(cells)
    field, coeff = spe10_coeff(cells)
    _reset_peak(device)
    (levels, outs), setup_s, _ = _timed(
        lambda: ml.spectral_coarsen_darcy_chain(
            cells, [tuple(f) for f in facs], coeff, h=field.sizes,
            spect_tol=spect_tol, max_evects=max_evects, dtype=np.float64,
            device=device), device)
    nu = int(outs[0].P2.shape[0])
    rec = dict(metric="spe10_structured_ml_setup", cells=list(cells),
               factors=[list(f) for f in facs], mode="direct",
               dtype="float64", nlevels=len(levels), ndofs_u=nu,
               coarse_u=[int(o.P2.shape[1]) for o in outs],
               coarse_p=[int(o.P3.shape[1]) for o in outs],
               ns_res=float(max(o.ns_res for o in outs)),
               ext_spot_err=float(max(o.ext_spot_err for o in outs)),
               stage_s=[o.stage_s for o in outs],
               stage_res=[o.stage_res for o in outs],
               setup_s=setup_s, value=nu / setup_s, unit="dof_per_s",
               peak_mem_bytes=_peak(device), device=str(device))
    if u_l2:
        P2, P3 = outs[0].P2, outs[0].P3
        for o in outs[1:]:
            P2, P3 = P2 @ o.P2, P3 @ o.P3
        fine = fine or fine_darcy(cells, coeff, field.sizes)
        rec["u_l2_rel"] = upscaling_error(fine, P2.tocsr(), P3.tocsr())
    return rec, (levels, outs)


def _cells(s):
    return tuple(int(v) for v in s.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(map(str, CELLS)),
                    help="spe10_structured cells nx,ny,nz, or 'none'")
    ap.add_argument("--full", action="store_true",
                    help="also the full SPE10 grid (60, 220, 85)")
    ap.add_argument("--ml", default=None,
                    help="spe10_ml cells nx,ny,nz (factors (4,4,2), "
                    "(2,2,2))")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--device", default=None,
                    help="torch device of the lanes (default: the card)")
    ap.add_argument("--profile", action="store_true",
                    help="trace each lane; add its top device kernels")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0] \
        if device.type == "cuda" else None
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    def run(lane, *a):
        if not args.profile:
            return emit(lane(*a, device=device)[0])
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            rec = lane(*a, device=device)[0]
        avg = sorted(prof.key_averages(), reverse=True,
                     key=lambda e: e.self_device_time_total)
        rec["top_device_kernels"] = [
            dict(name=e.key[:120], device_ms=e.self_device_time_total / 1e3,
                 calls=e.count) for e in avg[:15]
            if e.self_device_time_total > 0]
        emit(rec)

    emit(dict(card=smi, device=str(device), torch=torch.__version__,
              cuda=torch.version.cuda, numpy=np.__version__))
    grids = [] if args.cells == "none" else [_cells(args.cells)]
    grids += [FULL] if args.full else []
    for cells in grids:
        run(lane_spe10_structured, cells)
    if args.ml:
        run(lane_spe10_ml, _cells(args.ml))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
