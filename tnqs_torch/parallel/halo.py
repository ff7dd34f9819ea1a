"""Band-decomposed belief propagation with an explicit halo exchange (port
of `tnqs/parallel/halo.py`).

The lattice is cut into contiguous bands of vertices, one band a rank of a
1-D mesh.  Each rank owns its band's site tensors and the messages whose
source vertex lies in its band.  A BP sweep is a band-local batched update
plus, before each Gauss-Seidel stage, the halo exchange: the messages that
cross a band cut go to the neighbouring rank (`mesh.ppermute`, one hop each
way), everything else stays on the rank's device.

The plan (`HaloBandPlan`) is the JAX package's, table for table, built on
every rank from the same engine: cross-band edges must join adjacent bands,
and every per-band table is padded to the largest band, padding rows
writing into a trash slot.  Per band (this rank's): `HaloBP.Tb`, `Mb`,
`owned_mask`.  Replicated (the same on every rank): the plan, the
convergence difference of `fixed_point` (an `all_reduce`) and
`gather_messages`'s result.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine import _index
from ..ops.bp_sweep import bp_sweep_group, group_messages, supports_group
from .mesh import Mesh, all_gather, ppermute, psum


@dataclass
class HaloBandPlan:
    """Static band decomposition of a LatticePlan for halo-exchange BP."""

    n_bands: int
    band_of_vertex: dict
    # per degree k: [D, nb_k] global bucket positions (-1 = padding)
    band_vert_pos: dict
    # local message table size and mapping
    n_loc: int  # owned message slots per band (padded, +1 trash at index n_loc)
    eid_to_band_slot: dict  # directed edge -> (band, local slot)
    # halo tables (per band, padded with trash sends)
    n_up: int
    n_dn: int
    send_up: np.ndarray  # [D, n_up] local slots to send to band+1
    send_dn: np.ndarray  # [D, n_dn] local slots to send to band-1
    # BP groups in band-local terms:
    # (color, k, t, vert_rows [D, B], out_slots [D, B], in_refs [D, B, k-1], other_slots)
    # in_refs index the extended table [local | trash | halo_from_below | halo_from_above]
    groups: list

    @staticmethod
    def build(plan, n_bands: int, order=None) -> "HaloBandPlan":
        """`tnqs/parallel/halo.py:68`.  `order`: a vertex sort key for the band
        split.  The default keeps the plan's vertex order; ``order="sorted"``
        sorts the (x, y) vertex names, the column-major order that bands
        heavy-hex and Eagle lattices cleanly (their generator order
        interleaves columns and breaks the adjacent-band rule)."""
        verts = plan.vertices
        nv = len(verts)
        if order == "sorted":
            verts = sorted(verts)
        elif callable(order):
            verts = sorted(verts, key=order)
        band_of = {v: min(n_bands - 1, i * n_bands // nv) for i, v in enumerate(verts)}

        for (u, v) in plan.edge_ids:
            if abs(band_of[u] - band_of[v]) > 1:
                raise ValueError(
                    "halo BP requires cross-band edges to connect adjacent "
                    f"bands; edge {(u, v)} spans bands "
                    f"{band_of[u]}->{band_of[v]} (reorder vertices or reduce bands)")

        # per-band, per-degree vertex lists -> padded global bucket positions
        band_verts: dict = {b: {} for b in range(n_bands)}
        for v in verts:
            k, _ = plan.bucket_pos[v]
            band_verts[band_of[v]].setdefault(k, []).append(v)
        band_vert_pos = {}
        for k in plan.buckets:
            nb = max(1, max(len(band_verts[b].get(k, [])) for b in range(n_bands)))
            arr = -np.ones((n_bands, nb), dtype=np.int32)
            for b in range(n_bands):
                for i, v in enumerate(band_verts[b].get(k, [])):
                    arr[b, i] = plan.bucket_pos[v][1]
            band_vert_pos[k] = arr

        # message ownership: the band of the source vertex
        owned: dict = {b: [] for b in range(n_bands)}
        for (u, v) in plan.edge_ids:
            owned[band_of[u]].append((u, v))
        n_loc = max(len(es) for es in owned.values())
        eid_to_band_slot = {e: (b, i) for b in range(n_bands) for i, e in enumerate(owned[b])}

        # halo: messages (w -> u) needed by band(u) but owned by band(w)
        need_up: dict = {b: [] for b in range(n_bands)}  # owned by b, needed by b+1
        need_dn: dict = {b: [] for b in range(n_bands)}  # owned by b, needed by b-1
        for (w, u) in plan.edge_ids:
            bw, bu = band_of[w], band_of[u]
            if bu == bw + 1:
                need_up[bw].append((w, u))
            elif bu == bw - 1:
                need_dn[bw].append((w, u))
        n_up = max(1, max(len(x) for x in need_up.values()))
        n_dn = max(1, max(len(x) for x in need_dn.values()))
        send_up = np.zeros((n_bands, n_up), dtype=np.int32)
        send_dn = np.zeros((n_bands, n_dn), dtype=np.int32)
        halo_slot_above: dict = {}  # edge -> slot in the receiver's from-below buffer
        halo_slot_below: dict = {}
        for b in range(n_bands):
            for i, e in enumerate(need_up[b]):
                send_up[b, i] = eid_to_band_slot[e][1]
                halo_slot_above[e] = i
            for i, e in enumerate(need_dn[b]):
                send_dn[b, i] = eid_to_band_slot[e][1]
                halo_slot_below[e] = i

        # the extended message table of a band: [0, n_loc) local, n_loc the
        # trash, then the halo from below, then the halo from above
        off_hb = n_loc + 1
        off_ha = off_hb + n_up

        def ref_of(e, b_consumer):
            bo, slot = eid_to_band_slot[e]
            if bo == b_consumer:
                return slot
            if bo == b_consumer - 1:
                return off_hb + halo_slot_above[e]
            if bo == b_consumer + 1:
                return off_ha + halo_slot_below[e]
            raise AssertionError

        # band-local BP groups: the plan's (stage, k, t) groups, rows split by
        # the source's band and padded to the largest band (-1 / trash)
        edge_by_id = {eid: e for e, eid in plan.edge_ids.items()}
        groups = []
        for (cu, k, t, src_pos, out_eids, in_eids, other_slots) in plan.bp_groups:
            rows: dict = {b: [] for b in range(n_bands)}
            for r in range(len(src_pos)):
                v = plan.buckets[k][int(src_pos[r])]
                b = band_of[v]
                e = edge_by_id[int(out_eids[r])]
                in_refs = [ref_of(edge_by_id[int(in_eids[r, c])], b) for c in range(k - 1)]
                gpos = plan.bucket_pos[v][1]
                lrow = int(np.where(band_vert_pos[k][b] == gpos)[0][0])
                rows[b].append((lrow, eid_to_band_slot[e][1], in_refs))
            Bmax = max(1, max(len(x) for x in rows.values()))
            vert_rows = -np.ones((n_bands, Bmax), dtype=np.int32)
            out_slots = np.full((n_bands, Bmax), n_loc, dtype=np.int32)
            in_refs_arr = np.zeros((n_bands, Bmax, max(1, k - 1)), dtype=np.int32)
            for b in range(n_bands):
                for i, (lrow, oslot, irefs) in enumerate(rows[b]):
                    vert_rows[b, i] = lrow
                    out_slots[b, i] = oslot
                    for c, ir in enumerate(irefs):
                        in_refs_arr[b, i, c] = ir
            groups.append((cu, k, t, vert_rows, out_slots, in_refs_arr, other_slots))

        return HaloBandPlan(n_bands=n_bands, band_of_vertex=band_of, band_vert_pos=band_vert_pos, n_loc=n_loc,
                            eid_to_band_slot=eid_to_band_slot, n_up=n_up, n_dn=n_dn, send_up=send_up,
                            send_dn=send_dn, groups=groups)


class _BandSweep:
    """One band's BP sweep over the extended message table: per stage the
    width-1 halo exchange, then every group of the stage from the stage's
    messages (a Gauss-Seidel barrier), as `tnqs/parallel/halo.py:257-324`.
    With `use_kernel` and the engine's ``bp_kernel="kernel"``, a group that
    `supports_group` admits runs the fused BP kernel on the band's gathered
    rows; the rest, and every group under autograd, the einsum chain."""

    def __init__(self, engine, hplan: HaloBandPlan, mesh: Mesh):
        dev, b = engine.device, mesh.rank
        self.engine, self.hplan, self.mesh = engine, hplan, mesh
        self.D = hplan.n_bands
        self.off_hb = hplan.n_loc + 1
        self.off_ha = self.off_hb + hplan.n_up
        self.send_up = _index(hplan.send_up[b], dev)
        self.send_dn = _index(hplan.send_dn[b], dev)
        self.stages = sorted({g[0] for g in hplan.groups})
        self.groups = []
        for (cu, k, t, vert_rows, out_slots, in_refs, other_slots) in hplan.groups:
            rows = vert_rows[b]
            valid = rows >= 0
            slots = np.where(valid, out_slots[b], hplan.n_loc)
            self.groups.append((cu, k, t, _index(np.where(valid, rows, 0), dev), _index(slots, dev),
                                _index(in_refs[b][:, :k - 1], dev)))

    def exchange(self, Ml: torch.Tensor) -> torch.Tensor:
        """Refresh the halo regions from the neighbouring bands."""
        if self.D == 1:
            return Ml
        hp = self.hplan
        fb = ppermute(Ml[self.send_up], self.mesh, [(i, i + 1) for i in range(self.D - 1)])
        fa = ppermute(Ml[self.send_dn], self.mesh, [(i, i - 1) for i in range(1, self.D)])
        # the two halo regions are adjacent: [.. trash | from below | from above | ..]
        return torch.cat([Ml[:self.off_hb], fb, fa, Ml[self.off_ha + hp.n_dn:]])

    def __call__(self, Tl: dict, Ml: torch.Tensor, use_kernel: bool = True, splits: dict | None = None):
        eng = self.engine
        kernel = use_kernel and eng.bp_kernel == "kernel"
        mode = "bf16_3x" if eng.bp_precision == "high" else "highest"
        splits = splits or {}
        for stage in self.stages:
            Ml = self.exchange(Ml)
            out = Ml.clone()
            for (cu, k, t, rows, slots, irefs) in self.groups:
                if cu != stage:
                    continue
                if kernel and supports_group(k, eng.chi, eng.dtype):
                    m_new = bp_sweep_group(Tl[k], Ml[irefs], rows, t, mode, splits.get(k))
                else:
                    m_new = group_messages(Tl[k][rows], [Ml[irefs[:, c]] for c in range(k - 1)], t)
                norm = torch.sum(m_new, dim=(1, 2), keepdim=True)
                # padding rows land in the trash slot
                out[slots] = m_new / torch.where(torch.abs(norm) > 0, norm, 1.0)
            Ml = out
        return Ml


def _band_diff(Ma: torch.Tensor, Mb: torch.Tensor, mask: torch.Tensor):
    """(sum over the owned slots of the message infidelity, owned count)."""
    na = torch.linalg.vector_norm(Ma.reshape(Ma.shape[0], -1), dim=1)
    nb = torch.linalg.vector_norm(Mb.reshape(Mb.shape[0], -1), dim=1)
    dot = torch.sum(Ma.conj() * Mb, dim=(1, 2))
    denom = torch.where(na * nb > 0, na * nb, 1.0)
    return torch.sum((1.0 - torch.abs(dot / denom) ** 2) * mask), torch.sum(mask)


class HaloBP:
    """Halo-exchange BP sweeps for a `LatticeEngine` over a 1-D mesh: this
    rank's band of site tensors `Tb` {k: [nb_k, d, chi x k]} and of messages
    `Mb` [n_loc + 1 + n_up + n_dn, chi, chi] (`tnqs/parallel/halo.py:201`)."""

    def __init__(self, engine, hplan: HaloBandPlan, mesh: Mesh):
        if mesh.size != hplan.n_bands:
            raise ValueError("mesh size must equal the number of bands")
        self.engine = engine
        self.hplan = hplan
        self.mesh = mesh
        self._sweep = _BandSweep(engine, hplan, mesh)
        self._shard_state()

    def _shard_state(self):
        eng, hp, b = self.engine, self.hplan, self.mesh.rank
        self.Tb = {}
        for k, arr in eng.T.items():
            pos = hp.band_vert_pos[k][b]
            band = arr.new_zeros((len(pos),) + tuple(arr.shape[1:]))
            band[_index(np.nonzero(pos >= 0)[0], eng.device)] = arr[_index(pos[pos >= 0], eng.device)]
            self.Tb[k] = band
        n_slots = hp.n_loc + 1 + hp.n_up + hp.n_dn
        self.Mb = eng.M.new_zeros((n_slots, eng.chi, eng.chi))
        mask = np.zeros(hp.n_loc, dtype=np.float32)
        eids, slots = [], []
        for e, eid in eng.plan.edge_ids.items():
            bb, slot = hp.eid_to_band_slot[e]
            if bb == b:
                eids.append(eid)
                slots.append(slot)
                mask[slot] = 1.0
        self.Mb[_index(slots, eng.device)] = eng.M[_index(eids, eng.device)]
        self.owned_mask = torch.as_tensor(mask, device=eng.device).to(eng.real_dtype)

    def gather_messages(self) -> torch.Tensor:
        """The messages in the engine's [2E, chi, chi] layout, on every rank."""
        allb = all_gather(self.Mb, self.mesh)
        band, slot = _global_layout(self.engine, self.hplan)
        return allb[band, slot]

    def fixed_point(self, maxiter: int = 25, tolerance: float = 1e-5) -> torch.Tensor:
        """Sweeps to convergence (`tnqs/parallel/halo.py:326`): the first
        sweep counts as iteration 1; then sweep while ``it < maxiter`` and
        the mean infidelity over every owned message, summed over the ranks
        by `all_reduce`, exceeds `tolerance` (one host read a sweep)."""
        eng = self.engine
        Tb = {k: v.contiguous() for k, v in self.Tb.items()}
        splits = eng._bp_splits(Tb) if eng.bp_kernel == "kernel" else {}
        n_loc = self.hplan.n_loc

        def diff(Ma, Mb_):
            s, c = _band_diff(Ma[:n_loc], Mb_[:n_loc], self.owned_mask)
            s, c = psum(torch.stack([s, c]), self.mesh)
            return s / c

        M_cur = self._sweep(Tb, self.Mb, splits=splits)
        eps = diff(self.Mb, M_cur)
        it = 1
        while it < maxiter and float(eps) > tolerance:
            M_new = self._sweep(Tb, M_cur, splits=splits)
            eps = diff(M_cur, M_new)
            M_cur = M_new
            it += 1
        self.Mb = M_cur
        return self.Mb


def _global_layout(engine, hplan: HaloBandPlan):
    """(band, slot) of every directed edge id, as device index tensors."""
    E2 = engine.plan.num_edges
    band, slot = np.zeros(E2, np.int64), np.zeros(E2, np.int64)
    for e, eid in engine.plan.edge_ids.items():
        band[eid], slot[eid] = hplan.eid_to_band_slot[e]
    return _index(band, engine.device), _index(slot, engine.device)
