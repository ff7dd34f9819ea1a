"""The whole layer step (gates and BP) over a 1-D mesh with explicit halo
exchange (port of `tnqs/parallel/halo_step.py`).

`halo.py` shards the BP sweep; this module takes the same band
decomposition to the complete Trotter layer: one-site kicks, the two-site
simple update and the interleaved BP refreshes, with `mesh.ppermute` halo
traffic and no global collective but the final sum of the truncation
errors.

Execution model, domain decomposition with redundant boundary compute:

* every band owns its vertices' tensors and its out-messages (source-band
  ownership, as in `HaloBandPlan`);
* a two-site gate runs on the band(s) owning either endpoint.  A
  cut-crossing gate runs on both adjacent bands, from identical exchanged
  inputs, and each band writes only what it owns, so no write-back hop is
  needed.  That is exact only if the two runs give the same bits, so they
  run the same batch: a band splits each two-site group into three
  sub-groups, the gates within the band and the gates crossing each of its
  two cuts, and the sub-group of a cut holds the same gates in the same
  order on both of its bands (the JAX step runs a band's gates as one
  batch, where XLA's fixed program makes the two runs agree).  A route
  that gives the same bits for the same batch (the Jacobi kernels K2 and
  K1 through `pjsvd`, cuBLAS's and cuSOLVER's batched calls, the CPU's
  LAPACK) then gives the two halves the same bits; `cut_halves` checks it
  on the device at hand;
* before each two-site group one halo round brings (a) ghost copies of the
  neighbouring bands' vertex tensors (distance 1) and (b) the environment
  messages the group's gates read, which can be owned up to two bands
  away: four message transfers (distances +-1, +-2) whose slots come from
  the compiled circuit;
* the BP refreshes between groups use `HaloBandPlan`'s width-1 message
  halo with fixed sweep counts (no global convergence test; the final run
  is `bp_maxiter` sweeps).

Every per-band table is padded to the largest band, as JAX's are (its
ranks run one program); the port's ranks run their own shapes, so a band
leaves the padding rows of a two-site class out of its sub-groups.
Padding rows of a one-site group and padding messages land in trash slots.

The band-local program calls the port engine's `_apply_two_site_group` (or
`_apply_two_site_class` on the direct path) on the band's extended tables,
which it updates in place; the JAX engine returns new arrays.

Per band (this rank's): `Tb`, `Mb`.  Replicated: the plan, the step's
errors (summed over the ranks; each gate counted by the band owning its
first vertex) and `unshard`'s state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..engine import _ClassData, _index, _TwoSiteClass, build_program, compile_circuit
from .halo import HaloBandPlan, _BandSweep
from .mesh import Mesh, all_gather, ppermute, psum


@dataclass
class _ClassTables:
    """One two-site class, band-stacked: every array is [D, B, ...]."""

    ku: int
    kv: int
    u_rows: np.ndarray
    v_rows: np.ndarray
    slot_u: np.ndarray
    slot_v: np.ndarray
    env_u: np.ndarray  # [D, B, ku-1] extended-message refs
    env_v: np.ndarray
    w_uv: np.ndarray  # [D, B] write slot (owned) or msg trash
    w_vu: np.ndarray
    err_idx: np.ndarray  # [D, B] gate index (u-owner band) or n_gates
    gates: np.ndarray  # [D, B, d, d, d, d]


@dataclass
class HaloStepPlan:
    """Static band-stacked tables for one circuit layer
    (`tnqs/parallel/halo_step.py:83`)."""

    n_bands: int
    hplan: HaloBandPlan
    n_gates: int
    own_n: dict
    gfb_n: dict  # ghosts-from-below count per bucket
    gfa_n: dict
    ext_n: dict  # own + gfb + gfa + 2 (zero row, trash row)
    gsend_up: dict  # k -> [D, gfb_n[k]] owned local rows for receiver b+1
    gsend_dn: dict  # k -> [D, gfa_n[k]]
    # message table: base = halo.py layout [local | trash | hb1 | ha1],
    # then one region per transfer distance dd, then a clean zero slot
    n_msg_base: int
    msg_off: dict  # dd -> region offset
    msg_n: dict  # dd -> region size
    msg_send: dict  # dd -> [D, msg_n[dd]] owned local slots
    zslot: int
    n_msg_ext: int
    # ("bp",), ("one", {k: (pos [D, B], gates [D, B, d, d])}), ("two", [_ClassTables, ...])
    program: list = field(default_factory=list)


def _build_step_plan(engine, hplan: HaloBandPlan, circuit) -> HaloStepPlan:
    """The step's tables (`tnqs/parallel/halo_step.py:115`), pure numpy."""
    plan = engine.plan
    d = engine.d
    D = hplan.n_bands
    band_of = hplan.band_of_vertex
    edge_by_id = {eid: e for e, eid in plan.edge_ids.items()}
    compiled = compile_circuit(plan, circuit, d=d)
    program_src = build_program(plan, compiled)
    n_gates = len(circuit)

    # local owned row of each vertex inside its band bucket table
    own_row = {}
    for k, tbl in hplan.band_vert_pos.items():
        pos_to_row = {(b, int(p)): i for b in range(D) for i, p in enumerate(tbl[b]) if p >= 0}
        for v in plan.vertices:
            kk, p = plan.bucket_pos[v]
            if kk == k:
                own_row[v] = pos_to_row[(band_of[v], int(p))]
    own_n = {k: tbl.shape[1] for k, tbl in hplan.band_vert_pos.items()}

    # ---- pass 1: ghost vertices and remote message needs ---------------
    ghosts_below: dict = {b: {k: [] for k in own_n} for b in range(D)}  # owned by b-1
    ghosts_above: dict = {b: {k: [] for k in own_n} for b in range(D)}
    msg_need: dict = {dd: {b: [] for b in range(D)} for dd in (1, -1, 2, -2)}

    def ghost_row(v, b):
        k = plan.bucket_pos[v][0]
        bv = band_of[v]
        if bv == b:
            return ("own", k, own_row[v])
        if bv == b - 1:
            lst = ghosts_below[b][k]
            if v not in lst:
                lst.append(v)
            return ("gfb", k, lst.index(v))
        if bv == b + 1:
            lst = ghosts_above[b][k]
            if v not in lst:
                lst.append(v)
            return ("gfa", k, lst.index(v))
        raise ValueError(f"gate endpoint {v} is {abs(bv - b)} bands away from executor "
                         f"band {b}; halo step requires adjacent bands")

    def msg_ref(eid, b):
        e = edge_by_id[int(eid)]
        bo, slot = hplan.eid_to_band_slot[e]
        if bo == b:
            return ("loc", slot)
        dd = b - bo
        if abs(dd) > 2:
            raise ValueError(f"gate environment message {e} is owned {abs(dd)} bands from "
                             f"its reader; halo step supports width-2 message halos")
        lst = msg_need[dd][b]
        if e not in lst:
            lst.append(e)
        return ("g", dd, lst.index(e))

    sym_program: list = []
    for entry in program_src:
        if entry[0] == "bp":
            sym_program.append(("bp",))
        elif entry[0] == "one":
            rows: dict = {}
            for k, (pos, gates, _gi) in entry[1].per_bucket.items():
                for r in range(len(pos)):
                    v = plan.buckets[k][int(pos[r])]
                    rows.setdefault(k, {bb: [] for bb in range(D)})[band_of[v]].append((own_row[v], gates[r]))
            sym_program.append(("one", rows))
        else:
            sym_classes = []
            for cls in entry[1].classes:
                rows = {b: [] for b in range(D)}
                for r in range(len(cls.u_pos)):
                    u = plan.buckets[cls.ku][int(cls.u_pos[r])]
                    v = plan.buckets[cls.kv][int(cls.v_pos[r])]
                    bu, bv = band_of[u], band_of[v]
                    for b in sorted({bu, bv}):
                        rows[b].append(dict(
                            u=ghost_row(u, b),
                            v=ghost_row(v, b),
                            su=int(cls.slot_u[r]),
                            sv=int(cls.slot_v[r]),
                            eu=[msg_ref(x, b) for x in cls.env_u_eids[r]],
                            ev=[msg_ref(x, b) for x in cls.env_v_eids[r]],
                            w_uv=("loc", hplan.eid_to_band_slot[edge_by_id[int(cls.eid_uv[r])]][1]) if bu == b else None,
                            w_vu=("loc", hplan.eid_to_band_slot[edge_by_id[int(cls.eid_vu[r])]][1]) if bv == b else None,
                            err=int(cls.gate_index[r]) if bu == b else None,
                            gate=cls.gates[r],
                        ))
                sym_classes.append((cls.ku, cls.kv, rows))
            sym_program.append(("two", sym_classes))

    # ---- pass 2: freeze offsets and materialize tables ----------------
    gfb_n = {k: max(1, max(len(ghosts_below[b][k]) for b in range(D))) for k in own_n}
    gfa_n = {k: max(1, max(len(ghosts_above[b][k]) for b in range(D))) for k in own_n}
    ext_n = {k: own_n[k] + gfb_n[k] + gfa_n[k] + 2 for k in own_n}

    def resolve_row(sym):
        tag, k, i = sym
        if tag == "own":
            return i
        if tag == "gfb":
            return own_n[k] + i
        return own_n[k] + gfb_n[k] + i

    gsend_up, gsend_dn = {}, {}
    for k in own_n:
        su = np.zeros((D, gfb_n[k]), dtype=np.int32)
        sd = np.zeros((D, gfa_n[k]), dtype=np.int32)
        for b in range(D):
            if b + 1 < D:
                for i, v in enumerate(ghosts_below[b + 1][k]):
                    su[b, i] = own_row[v]  # owned by b, ghost on b+1
            if b - 1 >= 0:
                for i, v in enumerate(ghosts_above[b - 1][k]):
                    sd[b, i] = own_row[v]
        gsend_up[k], gsend_dn[k] = su, sd

    n_msg_base = hplan.n_loc + 1 + hplan.n_up + hplan.n_dn
    msg_off, msg_n, msg_send = {}, {}, {}
    cursor = n_msg_base
    for dd in (1, -1, 2, -2):
        n_r = max(1, max(len(msg_need[dd][b]) for b in range(D)))
        msg_off[dd], msg_n[dd] = cursor, n_r
        cursor += n_r
        tbl = np.zeros((D, n_r), dtype=np.int32)
        for b in range(D):  # band b sends the buffer for receiver b+dd
            r = b + dd
            if 0 <= r < D:
                for i, e in enumerate(msg_need[dd][r]):
                    tbl[b, i] = hplan.eid_to_band_slot[e][1]
        msg_send[dd] = tbl
    zslot = cursor
    n_msg_ext = cursor + 1
    msg_trash = hplan.n_loc

    def resolve_msg(sym):
        if sym is None:
            return msg_trash
        if sym[0] == "loc":
            return sym[1]
        return msg_off[sym[1]] + sym[2]

    sp = HaloStepPlan(n_bands=D, hplan=hplan, n_gates=n_gates, own_n=own_n, gfb_n=gfb_n, gfa_n=gfa_n, ext_n=ext_n,
                      gsend_up=gsend_up, gsend_dn=gsend_dn, n_msg_base=n_msg_base, msg_off=msg_off, msg_n=msg_n,
                      msg_send=msg_send, zslot=zslot, n_msg_ext=n_msg_ext)

    for entry in sym_program:
        if entry[0] == "bp":
            sp.program.append(("bp",))
        elif entry[0] == "one":
            out = {}
            for k, by_band in entry[1].items():
                B = max(1, max(len(x) for x in by_band.values()))
                pos = np.full((D, B), ext_n[k] - 1, dtype=np.int32)  # the trash row
                gts = np.tile(np.eye(d, dtype=np.complex128), (D, B, 1, 1))
                for b in range(D):
                    for i, (row, g) in enumerate(by_band[b]):
                        pos[b, i] = row
                        gts[b, i] = g
                out[k] = (pos, gts)
            sp.program.append(("one", out))
        else:
            cls_tables = []
            for (ku, kv, rows) in entry[1]:
                B = max(1, max(len(x) for x in rows.values()))
                zu, zv = ext_n[ku] - 2, ext_n[kv] - 2  # clean zero rows
                t = _ClassTables(
                    ku=ku, kv=kv,
                    u_rows=np.full((D, B), zu, dtype=np.int32),
                    v_rows=np.full((D, B), zv, dtype=np.int32),
                    slot_u=np.zeros((D, B), dtype=np.int32),
                    slot_v=np.zeros((D, B), dtype=np.int32),
                    env_u=np.full((D, B, max(1, ku - 1)), zslot, dtype=np.int32),
                    env_v=np.full((D, B, max(1, kv - 1)), zslot, dtype=np.int32),
                    w_uv=np.full((D, B), msg_trash, dtype=np.int32),
                    w_vu=np.full((D, B), msg_trash, dtype=np.int32),
                    err_idx=np.full((D, B), n_gates, dtype=np.int32),
                    gates=np.tile(np.eye(d * d, dtype=np.complex128).reshape(d, d, d, d), (D, B, 1, 1, 1, 1)),
                )
                for b in range(D):
                    for i, r in enumerate(rows[b]):
                        t.u_rows[b, i] = resolve_row(r["u"])
                        t.v_rows[b, i] = resolve_row(r["v"])
                        t.slot_u[b, i], t.slot_v[b, i] = r["su"], r["sv"]
                        for c, sym in enumerate(r["eu"]):
                            t.env_u[b, i, c] = resolve_msg(sym)
                        for c, sym in enumerate(r["ev"]):
                            t.env_v[b, i, c] = resolve_msg(sym)
                        t.w_uv[b, i] = resolve_msg(r["w_uv"])
                        t.w_vu[b, i] = resolve_msg(r["w_vu"])
                        if r["err"] is not None:
                            t.err_idx[b, i] = r["err"]
                        t.gates[b, i] = r["gate"]
                cls_tables.append(t)
            sp.program.append(("two", cls_tables))
    return sp


def _band_tables(engine, sp: HaloStepPlan, b: int):
    """Band b's extended tables (`Tb`, `Mb`) from the engine's replicated
    state: its own rows and message slots, and its ghost rows and gate-halo
    message regions as `HaloStepEngine._exchange_gates` fills them (padding
    entries included); the BP halo regions, the zero rows and the trash
    slots stay zero."""
    hp, dev, D = sp.hplan, engine.device, sp.n_bands
    Tb = {}
    for k, arr in engine.T.items():
        pos = np.full(sp.ext_n[k], -1)
        o = sp.own_n[k]
        pos[:o] = hp.band_vert_pos[k][b]
        if b > 0:  # ghosts from below: band b-1's rows gsend_up[k][b-1]
            pos[o:o + sp.gfb_n[k]] = hp.band_vert_pos[k][b - 1][sp.gsend_up[k][b - 1]]
        o += sp.gfb_n[k]
        if b + 1 < D:
            pos[o:o + sp.gfa_n[k]] = hp.band_vert_pos[k][b + 1][sp.gsend_dn[k][b + 1]]
        band = arr.new_zeros((sp.ext_n[k],) + tuple(arr.shape[1:]))
        have = np.nonzero(pos >= 0)[0]
        band[_index(have, dev)] = arr[_index(pos[have], dev)]
        Tb[k] = band
    eid = np.full((D, hp.n_loc + 1), -1)  # each band's owned slots' edge ids
    for e, i in engine.plan.edge_ids.items():
        eid[hp.eid_to_band_slot[e]] = i
    ext = np.full(sp.n_msg_ext, -1)
    ext[:hp.n_loc] = eid[b, :hp.n_loc]
    for dd in (1, -1, 2, -2):
        src = b - dd  # the band that sends band b its distance-dd region
        if 0 <= src < D:
            ext[sp.msg_off[dd]:sp.msg_off[dd] + sp.msg_n[dd]] = eid[src][sp.msg_send[dd][src]]
    Mb = engine.M.new_zeros((sp.n_msg_ext, engine.chi, engine.chi))
    have = np.nonzero(ext >= 0)[0]
    Mb[_index(have, dev)] = engine.M[_index(ext[have], dev)]
    return Tb, Mb


def _band_program(sp: HaloStepPlan, b: int, dtype, device) -> list:
    """Band b's program on the device: ("bp", None), ("one", {k: (rows,
    gates)}) and ("two", (within, below, above)).  A two-site group's rows
    of band b, padding left out, fall in three sub-groups: the gates within
    the band, those crossing to band b-1 and those crossing to band b+1,
    each a list of per-class `_ClassData` (classes with no row left out).
    Band b's `above` and band b+1's `below` hold the same gates in the same
    order."""
    def region(rows, k):  # 0 own, 1 ghost from below, 2 ghost from above, 3 the zero row
        lo = sp.own_n[k] + sp.gfb_n[k]
        return np.select([rows < sp.own_n[k], rows < lo, rows < lo + sp.gfa_n[k]], [0, 1, 2], 3)

    program = []
    for entry in sp.program:
        if entry[0] == "bp":
            program.append(("bp", None))
        elif entry[0] == "one":
            program.append(("one", {k: (_index(pos[b], device), torch.as_tensor(g[b], device=device).to(dtype))
                                    for k, (pos, g) in entry[1].items()}))
        else:
            parts = ([], [], [])
            for ct in entry[1]:
                wu, wv = region(ct.u_rows[b], ct.ku), region(ct.v_rows[b], ct.kv)
                part = np.where(wu == 3, -1, np.maximum(wu, wv))
                for p in range(3):
                    sel = np.nonzero(part == p)[0]
                    if len(sel):
                        cls = _TwoSiteClass(ku=ct.ku, kv=ct.kv, u_pos=ct.u_rows[b][sel], v_pos=ct.v_rows[b][sel],
                                            slot_u=ct.slot_u[b][sel], slot_v=ct.slot_v[b][sel],
                                            env_u_eids=ct.env_u[b][sel, :ct.ku - 1],
                                            env_v_eids=ct.env_v[b][sel, :ct.kv - 1], eid_uv=ct.w_uv[b][sel],
                                            eid_vu=ct.w_vu[b][sel], gates=ct.gates[b][sel],
                                            gate_index=ct.err_idx[b][sel])
                        parts[p].append(_ClassData(cls, dtype, device))
            program.append(("two", parts))
    return program


def _two_site(engine, Tl, Ml, errors, classes: list, cutoff: float, normalize: bool) -> None:
    """One sub-group of a two-site group on a band's extended tables, in
    place, on the engine's factor path."""
    if not classes:
        return
    if engine.factor_method == "gram":
        engine._apply_two_site_group(Tl, Ml, errors, classes, cutoff, normalize)
    else:
        for cd in classes:
            engine._apply_two_site_class(Tl, Ml, errors, cd, cutoff, normalize)


def cut_halves(engine, n_bands: int, circuit, order=None, cutoff: float = 0.0, normalize: bool = True) -> dict:
    """Both halves of every cut-crossing gate of `circuit`, run here as the
    two bands of its cut run them (each its own sub-group on its own
    extended tables, filled from the engine's state as the halo exchange
    fills them), compared: the new tensors of both endpoints and the bond's
    singular-value message.  The halo step is exact where they are the same
    bits.  Needs no mesh; every two-site group starts from the engine's
    state.  Returns ``{"gates": cut-crossing gates compared, "equal": every
    compared pair the same bits, "max_abs_diff": the largest difference}``."""
    hplan = HaloBandPlan.build(engine.plan, n_bands, order=order)
    sp = _build_step_plan(engine, hplan, circuit)
    dt, dev = engine.dtype, engine.device
    tables = [_band_tables(engine, sp, b) for b in range(n_bands)]
    programs = [_band_program(sp, b, dt, dev) for b in range(n_bands)]
    trash = hplan.n_loc
    n, equal, worst = 0, True, 0.0
    for i, entry in enumerate(sp.program):
        if entry[0] != "two":
            continue
        for b in range(n_bands - 1):
            out = []
            for bb, part in ((b, 2), (b + 1, 1)):
                Tl = {k: v.clone() for k, v in tables[bb][0].items()}
                Ml = tables[bb][1].clone()
                errors = torch.zeros((sp.n_gates + 1,), dtype=engine.real_dtype, device=dev)
                classes = programs[bb][i][1][part]
                _two_site(engine, Tl, Ml, errors, classes, cutoff, normalize)
                got = []
                for cd in classes:
                    c = cd.cls
                    own = np.where(c.eid_uv != trash, c.eid_uv, c.eid_vu)  # the endpoint's bond message
                    got += [Tl[c.ku][_index(c.u_pos, dev)], Tl[c.kv][_index(c.v_pos, dev)], Ml[_index(own, dev)]]
                    n += len(c.u_pos) if bb == b else 0
                out.append(got)
            for x, y in zip(*out, strict=True):
                equal = equal and torch.equal(x, y)
                worst = max(worst, float((x - y).abs().max()) if x.numel() else 0.0)
    return {"gates": n, "equal": equal, "max_abs_diff": worst}


class HaloStepEngine:
    """Full-layer halo-sharded evolution of a `LatticeEngine`
    (`tnqs/parallel/halo_step.py:367`).  Every rank builds it from the same
    engine; each holds its band's extended tables `Tb` {k: [ext_n[k], d,
    chi x k]} and `Mb` [n_msg_ext, chi, chi].  Usage::

        hse = HaloStepEngine(engine, n_bands=8, mesh=mesh)
        step = hse.make_step(layer, cutoff=1e-12)
        hse.Tb, hse.Mb, errors = step(hse.Tb, hse.Mb)
        engine = hse.unshard()
    """

    def __init__(self, engine, n_bands: int, mesh: Mesh, order=None):
        if mesh.size != n_bands:
            raise ValueError("mesh size must equal the number of bands")
        self.engine = engine
        self.mesh = mesh
        # order="sorted" bands heavy-hex / Eagle lattices (see HaloBandPlan)
        self.hplan = HaloBandPlan.build(engine.plan, n_bands, order=order)
        self._sweep = _BandSweep(engine, self.hplan, mesh)
        self.Tb = None
        self.Mb = None

    # -- state layout ----------------------------------------------------
    def shard_state(self, sp: HaloStepPlan):
        """This rank's extended tables from the engine's state."""
        self.Tb, self.Mb = _band_tables(self.engine, sp, self.mesh.rank)
        return self.Tb, self.Mb

    def unshard(self):
        """The engine with every band's state gathered (on every rank)."""
        eng, hp = self.engine, self.hplan
        dev = eng.device
        T = {k: v.clone() for k, v in eng.T.items()}
        for k, tbl in hp.band_vert_pos.items():
            allb = all_gather(self.Tb[k][:tbl.shape[1]], self.mesh)  # [D, nb, ...]
            bs, rows = np.nonzero(tbl >= 0)
            T[k][_index(tbl[bs, rows], dev)] = allb[_index(bs, dev), _index(rows, dev)]
        allm = all_gather(self.Mb[:hp.n_loc], self.mesh)
        M = eng.M.clone()
        eids, bs, slots = [], [], []
        for e, eid in eng.plan.edge_ids.items():
            bb, slot = hp.eid_to_band_slot[e]
            eids.append(eid)
            bs.append(bb)
            slots.append(slot)
        M[_index(eids, dev)] = allm[_index(bs, dev), _index(slots, dev)]
        eng.T, eng.M = T, M
        return eng

    # -- exchanges -------------------------------------------------------
    def _exchange_gates(self, Tl: dict, Ml: torch.Tensor, sp: HaloStepPlan, send: dict):
        """Ghost rows of the neighbouring bands' vertices (distance 1) and
        the width-2 environment-message halo, written into the extended
        tables in place."""
        D = sp.n_bands
        if D == 1:
            return
        up = [(i, i + 1) for i in range(D - 1)]
        dn = [(i, i - 1) for i in range(1, D)]
        for k in Tl:
            o = sp.own_n[k]
            Tl[k][o:o + sp.gfb_n[k]] = ppermute(Tl[k][send["gup", k]], self.mesh, up)
            o += sp.gfb_n[k]
            Tl[k][o:o + sp.gfa_n[k]] = ppermute(Tl[k][send["gdn", k]], self.mesh, dn)
        for dd in (1, -1, 2, -2):
            if D <= abs(dd):
                continue
            perm = [(i, i + dd) for i in range(D) if 0 <= i + dd < D]
            Ml[sp.msg_off[dd]:sp.msg_off[dd] + sp.msg_n[dd]] = ppermute(Ml[send["msg", dd]], self.mesh, perm)

    def _bp_sweeps(self, Tl: dict, Ml: torch.Tensor, n_sweeps: int) -> torch.Tensor:
        """`n_sweeps` band-local BP sweeps, each stage after the width-1
        message halo (JAX's `_exchange_bp`, here `_BandSweep.exchange`, which
        `HaloBP` shares), on the engine's BP route (K3 where `bp_kernel` and
        `supports_group` say)."""
        eng = self.engine
        splits = {}
        if eng.bp_kernel == "kernel":
            for k in Tl:
                Tl[k] = Tl[k].contiguous()  # the kernel reads T in place
            splits = eng._bp_splits(Tl)
        for _ in range(n_sweeps):
            Ml = self._sweep(Tl, Ml, splits=splits)
        return Ml

    def halo_bytes_per_layer(self, circuit, bp_maxiter: int = 30, bp_inner_maxiter: int = 2) -> dict:
        """Per-rank halo traffic of one layer of `make_step`
        (`tnqs/parallel/halo_step.py:507`): the byte sizes of every
        `ppermute` buffer of the compiled program.  The port's BP refreshes
        run fixed sweep counts, as JAX's bound assumes, so `bp_sweeps` is
        what the step runs (``bp_refreshes * inner + bp_maxiter``)."""
        eng, hp = self.engine, self.hplan
        sp = _build_step_plan(eng, hp, circuit)
        chi = eng.chi
        itemsize = torch.empty((), dtype=eng.dtype).element_size()
        n_stages = len({g[0] for g in hp.groups})
        msg_bytes = (hp.n_up + hp.n_dn) * chi * chi * itemsize  # per stage
        inner = min(bp_maxiter, bp_inner_maxiter)
        bp_refreshes = sum(1 for e in sp.program if e[0] == "bp")
        bp_sweeps = bp_refreshes * inner + bp_maxiter  # + the final run
        bp_bytes = bp_sweeps * n_stages * msg_bytes
        gate_bytes = 0
        for entry in sp.program:
            if entry[0] != "two":
                continue
            for k in sp.ext_n:
                gate_bytes += (sp.gfb_n[k] + sp.gfa_n[k]) * eng.d * chi**k * itemsize
            for dd in (1, -1, 2, -2):
                if hp.n_bands > abs(dd):
                    gate_bytes += sp.msg_n[dd] * chi * chi * itemsize
        return dict(bp_bytes=int(bp_bytes), gate_bytes=int(gate_bytes), total_bytes=int(bp_bytes + gate_bytes),
                    bp_sweeps=int(bp_sweeps), n_stages=int(n_stages))

    # -- the step --------------------------------------------------------
    def make_step(self, circuit, cutoff: float = 0.0, normalize: bool = True, bp_maxiter: int = 30,
                  bp_inner_maxiter: int = 2):
        """``step(Tb, Mb) -> (Tb, Mb, errors)``, a collective: one layer of
        `circuit` on this rank's band (written in place), `errors` [n_gates]
        summed over the ranks."""
        eng, b = self.engine, self.mesh.rank
        dev, dt = eng.device, eng.dtype
        # the tables carry the gate matrices: built anew for each circuit
        sp = _build_step_plan(eng, self.hplan, circuit)
        if self.Tb is None:
            self.shard_state(sp)
        send = {}
        for k in sp.own_n:
            send["gup", k] = _index(sp.gsend_up[k][b], dev)
            send["gdn", k] = _index(sp.gsend_dn[k][b], dev)
        for dd in (1, -1, 2, -2):
            send["msg", dd] = _index(sp.msg_send[dd][b], dev)
        program = _band_program(sp, b, dt, dev)
        inner = min(bp_maxiter, bp_inner_maxiter)
        n_gates = sp.n_gates

        def step(Tb, Mb):
            Tl = dict(Tb)
            Ml = Mb
            errors = torch.zeros((n_gates + 1,), dtype=eng.real_dtype, device=dev)
            for kind, data in program:
                if kind == "bp":
                    Ml = self._bp_sweeps(Tl, Ml, inner)
                elif kind == "one":
                    eng._apply_one_site_group(Tl, data)
                else:
                    self._exchange_gates(Tl, Ml, sp, send)
                    for classes in data:
                        _two_site(eng, Tl, Ml, errors, classes, cutoff, normalize)
            Ml = self._bp_sweeps(Tl, Ml, bp_maxiter)
            return Tl, Ml, psum(errors, self.mesh)[:n_gates]

        return step
