"""Darcy mixed Hdiv-L2 problem family.

Rebuild of reference testsuite/unstructuredDarcy.cpp and
examples/MultigridTestDarcy.cpp: multilevel upscaling of the saddle system

    [ M   B^T ] [u]   [b]
    [ B   0   ] [p] = [q]      B = W D_div

with unit source q, natural pressure BC (free normal flux), only the
Hdiv->L2 tail of the sequence coarsened (jFormStart = dim-1,
unstructuredDarcy.cpp:229-231). Errors are reported in the reference's
protocol: u in the Hdiv mass norm, p and div-u in the L2 mass norm.
"""

from dataclasses import dataclass
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from parelag_tpu_torch.mesh.mesh import hex_grid_mesh
from parelag_tpu_torch.topology.topology import AgglomeratedTopology
from parelag_tpu_torch.amge.fespace import DeRhamSequenceFE
from parelag_tpu_torch.amge import hexfe
from parelag_tpu_torch.partitioning.partitioners import (
    refined_mesh_partition, graph_partition)


@dataclass
class DarcyResult:
    u_l2_errors: list
    p_l2_errors: list
    u_energy_errors: list
    ndofs: list
    iterations: list

    def print_report(self):
        fmt = lambda xs: " ".join(f"{x:.4e}" for x in xs)
        print(f"u l2-like errors: {fmt(self.u_l2_errors)} ")
        print(f"p l2-like errors: {fmt(self.p_l2_errors)} ")
        print(f"u energy-like errors: {fmt(self.u_energy_errors)} ")


def darcy_level_ne(ne, coarsening_factor=8, aggressive_levels=1):
    """level_NE schedule (unstructuredDarcy.cpp:167-181)."""
    level_ne = [ne]
    for _ in range(aggressive_levels):
        ne //= coarsening_factor * coarsening_factor
        level_ne.append(max(ne, 1))
        if ne < coarsening_factor:
            break
    while ne > coarsening_factor:
        ne //= coarsening_factor
        level_ne.append(max(ne, 1))
    return level_ne


def build_darcy_hierarchy(nref_parallel=1, coarsening_factor=8,
                          aggressive_levels=1, svd_tol=1e-9,
                          upscaling_order=0, kinv=None, mesh=None,
                          partition="metis"):
    if mesh is None:
        mesh = hex_grid_mesh(2, 2, 2)
    for _ in range(nref_parallel):
        mesh = mesh.uniform_refinement()
    level_ne = darcy_level_ne(mesh.num_elements, coarsening_factor,
                              aggressive_levels)
    n_levels = len(level_ne)

    topos = [AgglomeratedTopology.from_mesh(mesh)]
    for il in range(n_levels - 1):
        if level_ne[il + 1] == 1:
            part = np.zeros(topos[il].num_entities(0), dtype=np.int64)
        elif partition == "derefine":
            part = refined_mesh_partition(topos[il].num_entities(0),
                                          level_ne[il + 1])
        elif partition == "multilevel":
            from parelag_tpu_torch.partitioning.partitioners import (
                multilevel_graph_partition)
            part = multilevel_graph_partition(
                topos[il].local_element_element(), level_ne[il + 1], seed=0)
        else:
            part = graph_partition(topos[il].local_element_element(),
                                   level_ne[il + 1], seed=0)
        topos.append(topos[il].coarsen_local_partitioning(part))

    seq0 = DeRhamSequenceFE(topos[0], mesh)
    seq0.jform_start = 2
    if kinv is not None:
        seq0.replace_mass_integrator(2, kinv)
    seq0.set_upscaling_targets(upscaling_order)
    seqs = [seq0]
    for il in range(n_levels - 1):
        seqs.append(seqs[il].coarsen(svd_tol=svd_tol))
    return mesh, topos, seqs


def unstructured_darcy(nref_parallel=1, coarsening_factor=8,
                       aggressive_levels=1, svd_tol=1e-9,
                       upscaling_order=0, solver="direct",
                       rtol=1e-6, atol=1e-12, kinv=None,
                       mesh=None, partition="metis") -> DarcyResult:
    mesh, topos, seqs = build_darcy_hierarchy(
        nref_parallel, coarsening_factor, aggressive_levels, svd_tol,
        upscaling_order, kinv=kinv, mesh=mesh, partition=partition)
    n_levels = len(seqs)
    uform, pform = 2, 3

    Ml = [s.compute_mass_operator(uform) for s in seqs]
    Wl = [s.compute_mass_operator(pform) for s in seqs]
    Dl = [s.D[uform] for s in seqs]
    Pu = [seqs[i].P[uform] for i in range(n_levels - 1)]
    Pp = [seqs[i].P[pform] for i in range(n_levels - 1)]

    # rhs: b = 0 (zero flux data), q_i = int_E 1 * phi_i = cell volume
    vols = hexfe.hex_volumes(seqs[0].mesh.vertices[seqs[0].mesh.elements])
    rhs_u = [np.zeros(seqs[0].dof[uform].ndofs)]
    rhs_p = [vols.copy()]
    for i in range(n_levels - 1):
        rhs_u.append(Pu[i].T @ rhs_u[i])
        rhs_p.append(Pp[i].T @ rhs_p[i])

    sols_u, sols_p, iters, ndofs = [], [], [], []
    u_l2, p_l2, u_en = [], [], []
    for k in range(n_levels):
        B = (Wl[k] @ Dl[k]).tocsr()
        nu, npp = B.shape[1], B.shape[0]
        A = sp.bmat([[Ml[k], B.T], [B, None]], format="csr")
        b = np.concatenate([rhs_u[k], rhs_p[k]])
        if solver == "direct":
            x = spla.spsolve(A.tocsc(), b)
            it = 1
        else:
            x, it = _minres_block_solve(Ml[k], B, b, rtol, atol)
        u, p = x[:nu], x[nu:]
        sols_u.append(u)
        sols_p.append(p)
        iters.append(it)
        ndofs.append(nu + npp)

        hu, hp = u, p
        for j in range(k, 0, -1):
            hu = Pu[j - 1] @ hu
            hp = Pp[j - 1] @ hp
        if k > 0:
            du = hu - sols_u[0]
            dp = hp - sols_p[0]
            ddiv = Dl[0] @ du
            u_l2.append(float(np.sqrt(du @ (Ml[0] @ du))))
            p_l2.append(float(np.sqrt(dp @ (Wl[0] @ dp))))
            u_en.append(float(np.sqrt(ddiv @ (Wl[0] @ ddiv))))
    return DarcyResult(u_l2[::-1], p_l2[::-1], u_en[::-1], ndofs, iters)


def _minres_block_solve(M, B, b, rtol, atol, maxiter=5000):
    """MINRES with the reference's block-diagonal preconditioner:
    Jacobi on M, AMG-class solve on S = B diag(M)^-1 B^T
    (unstructuredDarcy.cpp:390-414)."""
    M = sp.csr_matrix(M)
    B = sp.csr_matrix(B)
    nu, npp = B.shape[1], B.shape[0]
    A = sp.bmat([[M, B.T], [B, None]], format="csr")
    dinv = 1.0 / M.diagonal()
    S = (B @ sp.diags(dinv) @ B.T).tocsc()
    S_lu = spla.splu(S)

    def prec(x):
        out = np.empty_like(x)
        out[:nu] = dinv * x[:nu]
        out[nu:] = S_lu.solve(x[nu:])
        return out

    it = [0]

    def cb(xk):
        it[0] += 1

    Pop = spla.LinearOperator(A.shape, matvec=prec)
    x, info = spla.minres(A, b, M=Pop, rtol=rtol, maxiter=maxiter,
                          callback=cb)
    return x, it[0]
