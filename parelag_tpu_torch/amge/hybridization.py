"""Hybridization of the Hdiv x L2 saddle-point problem (PyTorch).

Counterpart of parelag_tpu/amge/hybridization.py (reference
src/amge/HybridHdivL2.{hpp,cpp}): break Hdiv continuity element by
element, enforce it back with facet Lagrange multipliers, and eliminate
the element-local blocks,

    H = sum_e C_e A_e^{-1} C_e^T,   A_e = [M_e B_e^T; B_e -w W_e].

The host parts are the JAX package's numpy code, copied method for
method: the constructor (the batched per-element elimination),
rhs_transform, recover, _facet_blocks, _facet_block_inverse and
_host_amg_solve.  The multiplier solve on a torch device is new:
_device_setup builds the power-of-two padded, block-contiguous system,
its facet block-Jacobi smoother and the SA-AMG V-cycle
(solvers/sa_amg.py), and _device_solve runs PCG on that device inside
f64 host refinement (f32 on the card, up to 4 passes; f64 and one pass
on the CPU).  solve(), _device_setup and _device_solve take device=
(None: the card).  Dropped as TPU compile workarounds: the process-wide
jitted solver (_DEV_SOLVE), the padding of the BCSR column-block count
to a multiple of 8 and the ELL width padding (pad_to=4).
"""

import numpy as np
import scipy.sparse as sp
import scipy.linalg
import torch

from parelag_tpu_torch import resolve_device
from parelag_tpu_torch.ops import csr as C
from parelag_tpu_torch.utils.timing import counter, span


class HybridHdivL2:
    def __init__(self, seq, W_weight=0.0, ess_hdiv_dofs=None,
                 elem_matrix_scaling=None):
        """seq: a DeRhamSequence level (FE or algebraic) with M[(0,2)] local
        element mass blocks; W_weight: the -w W block weight."""
        self.seq = seq
        self.W_weight = W_weight
        dim = seq.dim
        self.uform, self.pform = dim - 1, dim

        topo = seq.topo
        self.topo = topo
        Wmass = seq.compute_mass_operator(self.pform)
        D = seq.D[self.uform]
        self.B = (Wmass @ D).tocsr()
        self.Wmass = Wmass

        local = seq.M[(0, self.uform)]
        elem_udofs = local.dofs              # per element Hdiv dof list
        elem_Mblocks = local.blocks
        ne = len(elem_udofs)
        nu = seq.dof[self.uform].ndofs
        npp = seq.dof[self.pform].ndofs
        self.nu, self.np = nu, npp
        elem_pdofs = seq.dof[self.pform].entity_dofs(0)
        facet_udofs = seq.dof[self.uform].entity_dofs(1)

        ess_hdiv = np.zeros(nu, dtype=bool) if ess_hdiv_dofs is None \
            else np.asarray(ess_hdiv_dofs, dtype=bool)

        # ---- facet adjacency and boundary attributes ---- #
        B0 = topo.B[0].tocsr()
        facet_nelem = np.asarray(
            C.pattern(B0).sum(axis=0)).ravel().astype(int)
        battr = topo.facet_bdr_attribute
        facet_is_bdr = np.asarray(
            C.pattern(battr).sum(axis=1)).ravel().astype(bool) \
            if battr is not None else np.zeros(len(facet_udofs), dtype=bool)

        # dof -> facet map (only for facet-supported dofs)
        from parelag_tpu_torch.ops import ragged as Rg
        fu_cat, fu_off = Rg.lists_to_cat(facet_udofs)
        dof_facet = np.full(nu, -1, dtype=np.int64)
        dof_facet[fu_cat] = np.repeat(
            np.arange(len(facet_udofs)), np.diff(fu_off))

        # ---- multiplier dofs: one per Hdiv dof on an active facet ---- #
        active_facet = (facet_nelem == 2) | facet_is_bdr
        has_mult = np.zeros(nu, dtype=bool)
        has_mult[fu_cat[np.repeat(active_facet, np.diff(fu_off))]] = True
        self.mult_of_dof = np.full(nu, -1, dtype=np.int64)
        self.mult_of_dof[has_mult] = np.arange(has_mult.sum())
        self.dof_of_mult = np.nonzero(has_mult)[0]
        n_mult = int(has_mult.sum())
        self.n_mult = n_mult

        # essential multipliers: natural-BC boundary dofs
        dof_is_bdr = np.zeros(nu, dtype=bool)
        dof_is_bdr[fu_cat[np.repeat(facet_is_bdr, np.diff(fu_off))]] = True
        self.ess_mult = np.zeros(n_mult, dtype=bool)
        sel = dof_is_bdr & (~ess_hdiv) & has_mult
        self.ess_mult[self.mult_of_dof[sel]] = True

        # ---- per-element elimination, shape-grouped and batched ---- #
        # (the reference's per-element LDL loop, HybridHdivL2.cpp:74-528;
        # here one batched inverse per shape group — embarrassingly
        # parallel, device-ready)
        Bg = self.B
        H = C.coo_builder()
        self.elem_udofs = elem_udofs
        self.elem_pdofs = elem_pdofs
        cct_diag = np.zeros(n_mult)
        cbt1 = np.zeros(n_mult)
        l2const = seq.L2_const_rep

        ud_cat, ud_off = Rg.lists_to_cat(elem_udofs)
        pd_cat, pd_off = Rg.lists_to_cat(elem_pdofs)
        Bls = C.extract_blocks_cat(Bg, pd_cat, pd_off, ud_cat, ud_off)
        Wls = (C.extract_blocks_cat(self.Wmass, pd_cat, pd_off,
                                    pd_cat, pd_off)
               if self.W_weight != 0.0 else None)
        # element -> facet sign lookup (orientation of the element's side)
        B0coo = B0.tocoo()
        sign_of = sp.csr_matrix(
            (B0coo.data, (B0coo.row, B0coo.col)), shape=B0.shape)

        # per-element multiplier structure (flat): for each element dof,
        # its multiplier id (or -1) and constraint sign
        elem_of = np.repeat(np.arange(ne), np.diff(ud_off))
        mi_cat = self.mult_of_dof[ud_cat]
        f_cat = dof_facet[ud_cat]
        # sign: +1 on boundary dofs, else the element's B0 orientation
        s_cat = np.where(
            dof_is_bdr[ud_cat], 1.0,
            np.asarray(sign_of[elem_of, f_cat]).ravel())
        keep = mi_cat >= 0
        # local multiplier tables per element (interior-order = dof order)
        lm_counts = np.bincount(elem_of[keep], minlength=ne)
        lm_off = Rg.sizes_to_offsets(lm_counts)
        lm_cat = mi_cat[keep]
        lrow_cat = (np.arange(ud_cat.size, dtype=np.int64)
                    - np.repeat(ud_off[:-1], np.diff(ud_off)))[keep]
        ls_cat = s_cat[keep]

        self._groups = []
        ksz = np.diff(ud_off)
        msz = np.diff(pd_off)
        sig = list(zip(ksz, msz, lm_counts))
        mblk_cat, mblk_off, mb_vals, mb_voff = (None,) * 4
        for (k, m, nl), idxs in Rg.group_by(sig).items():
            k, m, nl = int(k), int(m), int(nl)
            ii = np.asarray(idxs, dtype=np.int64)
            nsys = k + m
            A = np.zeros((ii.size, nsys, nsys))
            Mst = Rg.take(elem_Mblocks, ii, (k, k))
            if elem_matrix_scaling is not None:
                Mst = Mst * np.asarray(elem_matrix_scaling)[ii, None, None]
            A[:, :k, :k] = Mst
            Bst = Rg.take(Bls, ii, (m, k))
            A[:, k:, :k] = Bst
            A[:, :k, k:] = Bst.transpose(0, 2, 1)
            if Wls is not None:
                A[:, k:, k:] = -self.W_weight * Rg.take(Wls, ii, (m, m))

            lm_st = lm_cat[lm_off[ii][:, None] + np.arange(nl)]
            lr_st = lrow_cat[lm_off[ii][:, None] + np.arange(nl)]
            ls_st = ls_cat[lm_off[ii][:, None] + np.arange(nl)]
            Cst = np.zeros((ii.size, nl, nsys))
            bidx = np.repeat(np.arange(ii.size), nl)
            Cst[bidx, np.tile(np.arange(nl), ii.size),
                lr_st.ravel()] = ls_st.ravel()

            Ainv = np.linalg.inv(A)
            AinvCT = Ainv @ Cst.transpose(0, 2, 1)
            Hloc = Cst @ AinvCT
            Hloc = 0.5 * (Hloc + Hloc.transpose(0, 2, 1))
            H.add_blocks_var(
                lm_st.ravel(), np.arange(ii.size + 1) * nl,
                lm_st.ravel(), np.arange(ii.size + 1) * nl,
                Hloc.ravel())

            # rescaling vector pieces
            np.add.at(cct_diag, lm_st.ravel(),
                      (Cst ** 2).sum(axis=2).ravel())
            one = np.zeros((ii.size, nsys))
            one[:, k:] = l2const[pd_cat[pd_off[ii][:, None]
                                        + np.arange(m)]]
            Aone = np.einsum("bij,bj->bi", A, one)
            np.add.at(cbt1, lm_st.ravel(),
                      np.einsum("blj,bj->bl", Cst, Aone).ravel())

            self._groups.append(dict(
                idxs=ii, k=k, m=m, nl=nl,
                ud=ud_cat[ud_off[ii][:, None] + np.arange(k)],
                pd=pd_cat[pd_off[ii][:, None] + np.arange(m)],
                lm=lm_st, Ainv=Ainv, AinvCT=AinvCT))

        Hcsr = H.tocsr((n_mult, n_mult), sum_duplicates=True)
        Hcsr.sum_duplicates()
        self.hybrid_system = Hcsr
        self.rescaling = cbt1 / np.where(cct_diag > 0, cct_diag, 1.0)

    # ------------------------------------------------------------------ #
    def rhs_transform(self, rhs_u, rhs_p):
        """(HybridHdivL2::RHSTransform) returns (hybrid_rhs, essential_data)
        and caches per-element A^{-1} f for recovery (batched)."""
        g = np.zeros(self.n_mult)
        ess_data = np.zeros(self.n_mult)
        sel = self.mult_of_dof >= 0
        ess_data[self.mult_of_dof[sel]] = -np.asarray(rhs_u)[sel]
        for grp in self._groups:
            k, m = grp["k"], grp["m"]
            f = np.zeros((grp["idxs"].size, k + m))
            f[:, k:] = np.asarray(rhs_p)[grp["pd"]]
            grp["Ainv_f"] = np.einsum("bij,bj->bi", grp["Ainv"], f)
            np.add.at(g, grp["lm"].ravel(),
                      np.einsum("bjl,bj->bl", grp["AinvCT"], f).ravel())
        return g, ess_data

    def recover(self, mu):
        """(HybridHdivL2::RecoverOriginalSolution) multipliers -> (u, p)."""
        u = np.zeros(self.nu)
        p = np.zeros(self.np)
        for grp in self._groups:
            k = grp["k"]
            v = (np.einsum("bjl,bl->bj", grp["AinvCT"],
                           mu[grp["lm"]]) - grp["Ainv_f"])
            u[grp["ud"]] = -v[:, :k]
            p[grp["pd"]] = -v[:, k:]
        return u, p

    @staticmethod
    def _facet_blocks(Hcsr):
        """Block-Jacobi structure over multiplier supervariables: rows
        with identical sparsity patterns are the multiplier dofs of one
        facet, and the spectral coarse multiplier systems are
        near-singular under point Jacobi but well-conditioned under
        per-facet blocks (75 vs >8000 PCG iterations at the SPE10
        30x55x21 coarse level).

        Grouping is by a vectorized multiset hash of each row's column
        set; correctness does NOT depend on the grouping (any principal
        submatrix of an SPD matrix is SPD, so the block-diagonal inverse
        is SPD for every grouping).

        Returns (perm, buckets): a row permutation putting same-size
        blocks in contiguous segments (stable — all-singleton systems
        yield the identity, preserving any banded structure), and
        [(s, T)] buckets in segment order with T = (k,) inverse diagonal
        for s == 1 or (k, s, s) dense block inverses.
        """
        n = Hcsr.shape[0]
        indptr = Hcsr.indptr
        indices = Hcsr.indices
        rl = np.diff(indptr)
        if n == 0:
            return np.zeros(0, np.int64), []
        rng = np.random.RandomState(0x5eed)
        ch = (rng.randint(0, 2 ** 62, size=n).astype(np.uint64),
              rng.randint(0, 2 ** 62, size=n).astype(np.uint64))
        starts = np.minimum(indptr[:-1], max(len(indices) - 1, 0))
        hs = []
        for c in ch:
            h = (np.add.reduceat(c[indices], starts)
                 if len(indices) else np.zeros(n, np.uint64))
            h[rl == 0] = 0
            hs.append(h)
        key = np.stack([rl.astype(np.uint64)] + hs, axis=1)
        uk, first, grp = np.unique(key, axis=0, return_index=True,
                                   return_inverse=True)
        # renumber groups by first occurrence so the permutation stays
        # close to the original (often banded) row order
        rank = np.empty(uk.shape[0], np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(uk.shape[0])
        grp = rank[grp]
        order = np.argsort(grp, kind="stable")
        gsort = grp[order]          # group id per sorted position
        firsts = np.r_[0, np.flatnonzero(np.diff(gsort)) + 1]
        pos = np.arange(n) - np.repeat(firsts, np.diff(np.r_[firsts, n]))
        gs = gsort * 64 + pos // 64  # split pathological groups past 64
        _, gs = np.unique(gs, return_inverse=True)
        sizes = np.bincount(gs)
        s_of_pos = sizes[gs]        # block size per sorted position
        # segment-contiguous permutation: blocks ascending by size,
        # original order within each size class
        seg = np.argsort(s_of_pos, kind="stable")
        perm = order[seg]
        buckets = []
        for s in np.unique(sizes):
            sel = order[s_of_pos == s]
            k = sel.size // s
            rf = sel.reshape(k, s)
            if s == 1:
                d = Hcsr.diagonal()[rf[:, 0]]
                buckets.append((1, 1.0 / np.where(d != 0, d, 1.0)))
                continue
            flat = rf.ravel()
            X = Hcsr[flat][:, flat].tocoo()   # block-diagonal + cross junk
            keep = X.row // s == X.col // s   # keep the s x s diag blocks
            B = np.zeros((k, s, s))
            B[X.row[keep] // s, X.row[keep] % s, X.col[keep] % s] = \
                X.data[keep]
            buckets.append((int(s), np.linalg.inv(B)))
        return perm, buckets

    @staticmethod
    def _facet_block_inverse(Hcsr):
        """The _facet_blocks inverse assembled as a scipy CSR matrix in
        the ORIGINAL row numbering (host PCG path and tests)."""
        n = Hcsr.shape[0]
        perm, buckets = HybridHdivL2._facet_blocks(Hcsr)
        data, ri, ci = [], [], []
        o = 0
        for s, T in buckets:
            k = T.shape[0]
            rf = perm[o:o + k * s].reshape(k, s)
            o += k * s
            if s == 1:
                data.append(T)
                ri.append(rf[:, 0])
                ci.append(rf[:, 0])
            else:
                data.append(T.ravel())
                ri.append(np.repeat(rf, s, axis=1).ravel())
                ci.append(np.tile(rf, (1, s)).ravel())
        if not data:
            return sp.identity(n, format="csr")
        Binv = sp.csr_matrix(
            (np.concatenate(data),
             (np.concatenate(ri), np.concatenate(ci))), shape=(n, n))
        Binv.sum_duplicates()
        return Binv

    def _device_setup(self, Hcsr, device=None, dtype=None):
        """Device-solve setup on `device` (None: the card), cached per
        system content, device and dtype: the power-of-two padded system
        (identity pad rows), its block-contiguous permutation, the
        device operator and the SA-AMG hierarchy whose fine smoother is
        the damped facet block-Jacobi.  dtype None: f32 on the card, f64
        on the CPU.  The reference solves the multiplier system with
        PCG+BoomerAMG (ParELAG_HybridizationSolverFactory.cpp:135-141).
        Returns (perm, Hd, Hier, npad, dtype, f32)."""
        from parelag_tpu_torch.ops.device_sparse import (
            BlockDiagInverse, dia_ell_fill, from_scipy, to_bcsr, to_dia_ell)
        from parelag_tpu_torch.solvers.sa_amg import (
            build_device_sa_hierarchy)
        from parelag_tpu_torch.solvers.smoothers import BlockJacobiSmoother
        device = resolve_device(device)
        if dtype is None:
            dtype = np.float32 if device.type != "cpu" else np.float64
        dtype = np.dtype(dtype).type
        f32 = dtype == np.float32
        n = Hcsr.shape[0]
        key = (n, Hcsr.nnz, hash(Hcsr.data[
            :: max(1, Hcsr.nnz // 64)].tobytes()), str(device),
            np.dtype(dtype).name)
        cache = getattr(self, "_dev_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1:]
        # the power-of-two pad: _facet_blocks, the omega power iteration
        # and the SA aggregation all see it, so it stays as in the JAX
        # package (its counts of iterations depend on it)
        npad = 1 << max(int(np.ceil(np.log2(max(n, 1024)))), 0)
        Hp = sp.bmat(
            [[Hcsr, None],
             [None, sp.identity(npad - n, format="csr")]],
            format="csr").tocsr() if npad > n else Hcsr
        # facet-block fine smoother + block-contiguous permutation: the
        # solve runs in permuted coordinates so the block inverse applies
        # with static slices + a batched einsum
        perm, buckets = self._facet_blocks(Hp)
        Hq = Hp[perm][:, perm].tocsr()
        Bd = BlockDiagInverse(
            [torch.as_tensor(np.asarray(T).astype(dtype)) for _, T in buckets],
            [s for s, _ in buckets])
        # damping: omega ~ 1/rho(B^{-1}A) via a short host power iteration
        Binv = self._facet_block_inverse(Hq)
        rng = np.random.RandomState(0)
        v = rng.rand(Hq.shape[0])
        rho = 1.0
        for _ in range(10):
            w = Binv @ (Hq @ v)
            rho = np.linalg.norm(w)
            if rho <= 0:
                rho = 1.0
                break
            v = w / rho
        omega = 1.0 / max(rho, 1.0)
        smoother = BlockJacobiSmoother(Bd, sweeps=1, omega=omega)
        Hier, _, _ = build_device_sa_hierarchy(
            Hq.astype(np.float64), dtype=dtype, fine_smoother=smoother,
            device=device)
        # the JAX format rule: BCSR for wide rows (spectral coarse levels
        # reach kmax ~ 250), the DIA + COO split where 50 %+ of the
        # nonzeros sit on dense diagonals (structured meshes), else ELL
        kmax = int(np.diff(Hq.indptr).max()) if Hq.nnz else 1
        if kmax > 48:
            Hd = to_bcsr(Hq.astype(dtype), dtype=dtype, device=device)
        elif dia_ell_fill(Hq) >= 0.5:
            Hd = to_dia_ell(Hq.astype(dtype), dtype=dtype, device=device)
        else:
            Hd = from_scipy(Hq.astype(dtype), dtype=dtype, device=device)
        self._dev_cache = (key, perm, Hd, Hier, npad, dtype, f32)
        return perm, Hd, Hier, npad, dtype, f32

    def _device_solve(self, Hcsr, gf, rtol, device=None, dtype=None):
        """Multiplier solve on `device` (None: the card): SA-AMG
        preconditioned PCG (solvers/cg.pcg, stop r.z <= rtol^2 r0.z0,
        at most 2000 iterations) in permuted, padded coordinates inside
        f64 host residual refinement.  f32 (the card's default): up to 4
        passes, each to inner rtol max(rtol, 1e-6), until the true
        relative residual meets rtol (reliable-updates CG: the f32 loop
        stalls near its dtype floor); f64: one pass at rtol.  Sets
        last_iterations (all passes), last_passes, last_device (the
        solve's iterations, passes, true relative residual in host f64
        and formats), last_hierarchy (its SA hierarchy) and last_operator
        (the device operator its PCG applies)."""
        from parelag_tpu_torch.solvers.cg import pcg
        device = resolve_device(device)
        n = Hcsr.shape[0]
        perm, Hd, Hier, npad, dtype, f32 = self._device_setup(
            Hcsr, device, dtype)
        # spans: "hybrid.refine" the host work of the passes and the
        # copies between host and card, "krylov.pcg" (inside pcg) the
        # inner solves
        on_card = device.type != "cpu"
        with span("hybrid.refine"):
            H64 = Hcsr.astype(np.float64, copy=False)
            x = np.zeros(n)
            total_it = passes = 0
            nrm = np.linalg.norm(gf)
            inner_rt = max(rtol, 1e-6) if f32 else rtol   # f32 floor/sweep
            rfull = np.zeros(npad)
            dxfull = np.zeros(npad)
            r = gf - H64 @ x
        for _ in range(4 if f32 else 1):
            with span("hybrid.refine"):
                if np.linalg.norm(r) <= rtol * max(nrm, 1e-300):
                    break
                rfull[:n] = r
                b = torch.as_tensor(rfull[perm].astype(dtype)).to(device)
                if on_card:
                    counter("hybrid.h2d_bytes", b.numel() * b.element_size())
            dx, (it, _) = pcg(Hd.matvec, b, precond=Hier.cycle,
                              rtol=inner_rt, atol=0.0, maxiter=2000)
            with span("hybrid.refine"):
                dxh = dx.double().cpu()
                if on_card:
                    counter("hybrid.d2h_bytes",
                            dxh.numel() * dxh.element_size())
                dxfull[perm] = dxh.numpy()
                x = x + dxfull[:n]
                total_it += int(it)
                passes += 1
                r = gf - H64 @ x
        with span("hybrid.refine"):
            self.last_iterations = total_it
            self.last_passes = passes
            self.last_hierarchy = Hier
            self.last_operator = Hd
            # what a lane reports of this solve (a later host solve on the
            # same object overwrites last_iterations, never this)
            self.last_device = dict(
                device=str(device), dtype=np.dtype(dtype).name, n_mult=n,
                npad=npad, iters=total_it, passes=passes,
                rel_res=float(np.linalg.norm(r) / max(nrm, 1e-300)),
                format=type(Hd).__name__,
                dia_offsets=(len(Hd.dia.offs) if hasattr(Hd, "dia") else None),
                sa_level_sizes=[int(l.A.shape[0]) for l in Hier.levels],
                sa_formats=[type(l.A).__name__ for l in Hier.levels],
                sa_transfers=[f"{type(l.P).__name__}/{type(l.R).__name__}"
                              for l in Hier.levels if l.P is not None])
        return x

    def solve(self, rhs_u, rhs_p, solver="direct", rtol=1e-10,
              rescale=False, inner=None, device=None):
        """Full hybridized solve (the HybridizationSolver::Mult flow,
        ParELAG_HybridizationSolver.hpp:59-67).

        solver: "direct" | "cg" (facet-block-Jacobi PCG) | "amg" (SA-AMG
        preconditioned PCG — the reference's CG_PCG-AMG composition,
        CreateDarcyParameterList.hpp:60-80) | "device" (SA-AMG PCG on
        `device`, None: the card) | "auto" ("device" when `device`, or
        the default card, is a CUDA device; "amg" for device="cpu").
        `inner`, if given, overrides all of them: a callable
        (Hff, gf, rtol) -> xf or (xf, iterations) on the reduced
        (rescaled) multiplier system — the library's composed named
        solver (ParELAG_HybridizationSolverFactory.cpp:135-141)."""
        # spans, together the whole call but for the reduced system's
        # lookup and the device set-up's: "hybrid.transform",
        # "hybrid.reduce" (the essential lift and the free right-hand
        # side), the solver's ("hybrid.refine" and "krylov.pcg" on the
        # device), "hybrid.recover"; "hybrid.reduce_build" times the
        # reduced system's build, once per (rescale, format)
        with span("hybrid.transform"):
            g, ess_data = self.rhs_transform(rhs_u, rhs_p)
        if solver == "auto":
            solver = ("device" if resolve_device(device).type == "cuda"
                      else "amg")
        fmt = "csc" if inner is None and solver == "direct" else "csr"
        keep, d, Hff = self._reduced(rescale, fmt)
        with span("hybrid.reduce"):
            mu = np.zeros(self.n_mult)
            ess = self.ess_mult
            mu[ess] = ess_data[ess]
            g = g - self.hybrid_system @ (mu * ess)
            free = bool(keep.any())
            if free:
                gf = g[keep]
                if rescale:
                    gf = d * gf
        if free:
            xf = self._solve_free(Hff, gf, rtol, solver, inner, device)
        with span("hybrid.recover"):
            if free:
                mu[keep] = d * xf if rescale else xf
            return self.recover(mu)

    def _reduced(self, rescale, fmt):
        """(keep, d, Hff) of solve(): the free multipliers, the rescaling
        on them (None without `rescale`) and the free multiplier system,
        rescaled with `rescale`, in the solver's format `fmt` ("csc" the
        direct solve's, as the rescaling leaves it; "csr" every other
        solver's).  None of it depends on the right-hand side, so it is
        built on first use, under the span "hybrid.reduce_build", and
        kept per (rescale, fmt) for as long as hybrid_system is the same
        object.  Hff is handed to the solvers on every call: it is read
        only."""
        cache = getattr(self, "_reduced_cache", None)
        if cache is None or cache[0] is not self.hybrid_system:
            cache = self._reduced_cache = (self.hybrid_system, {})
        key = (bool(rescale), fmt)
        if key not in cache[1]:
            with span("hybrid.reduce_build"):
                keep = ~self.ess_mult
                d = Hff = None
                if keep.any():
                    Hff = self.hybrid_system[keep][:, keep].tocsc()
                    if rescale:
                        d = self.rescaling[keep]
                        d = np.where(np.abs(d) > 0, d, 1.0)
                        Hff = sp.diags(d) @ Hff @ sp.diags(d)
                    if fmt == "csr":
                        Hff = Hff.tocsr()
                cache[1][key] = (keep, d, Hff)
        return cache[1][key]

    def _solve_free(self, Hff, gf, rtol, solver, inner, device):
        """The free multiplier system's solve by `solver` (solve()'s
        names, "auto" resolved; Hff CSC for "direct", else CSR)."""
        import scipy.sparse.linalg as spla
        if inner is not None:
            out = inner(Hff, gf, rtol)
            xf, its = out if isinstance(out, tuple) else (out, 0)
            self.last_iterations = int(its)
        elif solver == "direct":
            xf = spla.spsolve(Hff, gf)
        elif solver == "device":
            xf = self._device_solve(Hff, gf, rtol, device=device)
        elif solver == "amg":
            xf = self._host_amg_solve(Hff, gf, rtol)
        else:
            Binv = self._facet_block_inverse(Hff)
            M = spla.LinearOperator(Hff.shape, matvec=lambda r: Binv @ r)
            it = [0]
            xf, info = spla.cg(Hff, gf, M=M, rtol=rtol,
                               atol=0.0, maxiter=2000,
                               callback=lambda x: it.__setitem__(
                                   0, it[0] + 1))
            self.last_iterations = it[0]
        return xf

    def _host_amg_solve(self, Hcsr, gf, rtol):
        """Host PCG + SA-AMG V-cycle on the multiplier system — the
        scipy-side mirror of the reference's PCG+BoomerAMG inner solve
        (near-flat iteration counts in h, vs the h-dependent one-level
        facet-block Jacobi)."""
        import scipy.sparse.linalg as spla
        from parelag_tpu_torch.solvers.sa_amg import (
            build_sa_hierarchy, HostVCycle)
        key = (Hcsr.shape[0], Hcsr.nnz)
        cache = getattr(self, "_host_amg_cache", None)
        if cache is None or cache[0] != key:
            A_l, P_l = build_sa_hierarchy(Hcsr)
            cache = (key, HostVCycle(A_l, P_l))
            self._host_amg_cache = cache
        M = spla.LinearOperator(Hcsr.shape, matvec=cache[1])
        it = [0]
        xf, info = spla.cg(Hcsr, gf, M=M, rtol=rtol, atol=0.0,
                           maxiter=2000,
                           callback=lambda x: it.__setitem__(
                               0, it[0] + 1))
        self.last_iterations = it[0]
        return xf
