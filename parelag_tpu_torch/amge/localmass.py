"""Per-entity local mass matrix containers.

The reference stores M_[(codim,form)] as block-diagonal sparse matrices over
"repeated dofs" (DeRhamSequence.hpp:614-727, ElementalMatricesContainer). We
store the same data as (entity dof lists, dense blocks) pairs — directly
consumable by batched device kernels and by the agglomerate assembly below.
"""

import numpy as np
import scipy.sparse as sp


class LocalMass:
    """Local mass matrices of one form on all entities of one codim.

    Canonical storage is the flat (dof_cat, dof_off, blk_cat, blk_off)
    layout (directly consumable by the native batched assembler and device
    kernels); the per-entity `dofs`/`blocks` list views are materialized
    lazily."""

    def __init__(self, dofs, blocks):
        self._dofs = [np.asarray(d) for d in dofs]     # per entity dof ids
        self._blocks = [np.asarray(b) for b in blocks]  # per entity (k,k)

    @classmethod
    def from_uniform(cls, dofs, blocks):
        """Uniform-arity fast path: dofs (n, k) ids, blocks (n, k, k).
        The block dtype is preserved (f32 setup pipelines stay f32)."""
        dofs = np.ascontiguousarray(np.asarray(dofs, dtype=np.int64))
        blocks = np.asarray(blocks)
        if blocks.dtype != np.float32:
            blocks = blocks.astype(np.float64, copy=False)
        blocks = np.ascontiguousarray(blocks)
        n, k = dofs.shape
        off = np.arange(n + 1, dtype=np.int64)
        return cls.from_cat(dofs.reshape(-1), off * k,
                            blocks.reshape(-1), off * (k * k))

    @classmethod
    def from_cat(cls, dof_cat, dof_off, blk_cat, blk_off):
        self = cls.__new__(cls)
        self._dofs = None
        self._blocks = None
        blk_cat = np.asarray(blk_cat)
        if blk_cat.dtype != np.float32:
            blk_cat = blk_cat.astype(np.float64, copy=False)
        self._cat = (np.ascontiguousarray(dof_cat.astype(np.int64,
                                                         copy=False)),
                     np.asarray(dof_off, np.int64),
                     np.ascontiguousarray(blk_cat),
                     np.asarray(blk_off, np.int64))
        return self

    @property
    def dofs(self):
        if self._dofs is None:
            dof_cat, dof_off, _, _ = self._cat
            self._dofs = np.split(dof_cat, dof_off[1:-1])
        return self._dofs

    @property
    def blocks(self):
        if self._blocks is None:
            dof_cat, dof_off, blk_cat, blk_off = self._cat
            k = np.diff(dof_off)
            self._blocks = [
                blk_cat[blk_off[i]:blk_off[i + 1]].reshape(
                    int(k[i]), int(k[i]))
                for i in range(dof_off.size - 1)]
        return self._blocks

    @property
    def n_entities(self):
        if getattr(self, "_cat", None) is not None:
            return self._cat[1].size - 1
        return len(self._dofs)

    def concatenated(self):
        """Cached flat layout (dof_cat, dof_off, blk_cat, blk_off) for the
        native batched assembler."""
        if getattr(self, "_cat", None) is None:
            n = len(self._dofs)
            dof_off = np.zeros(n + 1, np.int64)
            blk_off = np.zeros(n + 1, np.int64)
            np.cumsum([d.size for d in self._dofs], out=dof_off[1:])
            np.cumsum([b.size for b in self._blocks], out=blk_off[1:])
            dof_cat = (np.concatenate(self._dofs).astype(np.int64)
                       if n else np.zeros(0, np.int64))
            blk_cat = (np.concatenate([b.reshape(-1) for b in self._blocks])
                       .astype(np.float64) if n else np.zeros(0))
            self._cat = (np.ascontiguousarray(dof_cat), dof_off,
                         np.ascontiguousarray(blk_cat), blk_off)
        return self._cat

    def assemble_global(self, ndofs) -> sp.csr_matrix:
        """Scatter-add all blocks into the global (ndofs x ndofs) matrix
        (reference ComputeMassOperator). Vectorized over all entities."""
        from parelag_tpu_torch.ops import ragged as R
        dof_cat, dof_off, blk_cat, _ = self.concatenated()
        rows, cols = R.expand_blocks(dof_cat, dof_off, dof_cat, dof_off)
        A = sp.coo_matrix((blk_cat, (rows, cols)), shape=(ndofs, ndofs))
        return A.tocsr()


def assemble_agglomerate_blocks(local_mass: LocalMass, ae_entity,
                                dofagg, codim):
    """Per-AE dense matrices: sum of member entities' local blocks scattered
    into the AE's closure-dof positions.

    Equivalent of AssembleAgglomerateMatrix (DOFAgglomeration.cpp:533-547)
    which computes ADof_rDof * M_e * ADof_rDof^T; here directly:
    for AE: M_AE[pos(i),pos(j)] += M_loc_e[i,j] for each fine entity e in AE.

    Returns list of (n_ae_dofs x n_ae_dofs) dense arrays aligned with
    dofagg.ae_dofs(codim)[iae].
    """
    from parelag_tpu_torch.ops.csr import _col_scratch
    from parelag_tpu_torch.ops import native
    AE_e = ae_entity.tocsr()
    ndofs = dofagg.dof.ndofs
    pos = _col_scratch(ndofs)
    n_ae = AE_e.shape[0]

    if native.available():
        # one native call for the whole stage
        from parelag_tpu_torch.ops.ragged import BlockList
        dof_cat, dof_off, blk_cat, blk_off = local_mass.concatenated()
        ae_cat, ae_off = dofagg.ae_dofs_cat(codim)
        sizes = np.diff(ae_off)
        out_off = np.zeros(n_ae + 1, np.int64)
        np.cumsum(sizes * sizes, out=out_off[1:])
        from parelag_tpu_torch.utils.timing import TimeManager as _TM
        with _TM.add_timer("ae_blocks: zeros"):
            # np.empty: the native kernel zeroes each AE block in place,
            # cache-hot — a separate zeros pass over the (GB-scale)
            # output was the most host-phase-sensitive setup cost
            out_cat = np.empty(int(out_off[-1]), dtype=blk_cat.dtype)
        with _TM.add_timer("ae_blocks: kernel"):
            native.assemble_agglomerate_blocks_var(
                AE_e.indices.astype(np.int64),
                AE_e.indptr.astype(np.int64),
                dof_cat, dof_off, blk_cat, blk_off,
                np.ascontiguousarray(ae_cat), np.asarray(ae_off, np.int64),
                pos, out_cat, out_off)
        return BlockList(out_cat, out_off, sizes, sizes)

    ae_dofs_list = dofagg.ae_dofs(codim)
    out = []
    for iae in range(n_ae):
        ents = AE_e.indices[AE_e.indptr[iae]:AE_e.indptr[iae + 1]]
        ae_dofs = ae_dofs_list[iae]
        n = ae_dofs.size
        pos[ae_dofs] = np.arange(n)
        M = np.zeros((n, n))
        for e in ents:
            idx = pos[local_mass.dofs[e]]
            blk = local_mass.blocks[e]
            # scatter-add (duplicates impossible within one entity block)
            M[idx[:, None], idx[None, :]] += blk
        pos[ae_dofs] = -1
        out.append(M)
    return out
