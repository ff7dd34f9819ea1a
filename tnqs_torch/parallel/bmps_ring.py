"""The boundary-MPS measurement over a mesh (port of
`tnqs/parallel/bmps_ring.py`): the column sweep banded over the ranks
(`ShardedBMPS`) and the certified sampler's samples divided among them
(`ShardedSampler`).

**Columns** (`ShardedBMPS`).  The columns go to D contiguous bands, one a
rank.  The left and right boundary chains relay along the ranks: at each
of D-1 lockstep steps every rank sends its band's exit cut (the boundary
MPS leaving its last column, or its first for the right chain) to its
neighbour, rank + 1 for the left chain and rank - 1 for the right, each as
one flat buffer (`mesh.ppermute`).  Band r's left entry is exact after
step r-1, so rank r zips its band once, at step r, keeps the chain it
zipped (the cut entering each of its columns) and sends that exit again at
the later steps; the right chain is the mirror.  The JAX program, one
`lax.switch` branch a device inside a `fori_loop`, zips every band at
every step; a rank here is a process, so it zips only where its entry is
exact, and the values are the same.  Then every rank walks the ladders of
its own columns (`BMPSEngine._ladder_expect`), and `mesh.all_gather`
brings every band's values to every rank.  The sketches are keyed by
(column, direction, vertex), not by rank, so a band draws what the
unsharded sweep draws, and the values are the unsharded engine's.

A cut of a heavy-hex lattice carries another number of cross edges, with
other bond shapes, than its neighbour's, while a buffer sent along the
ranks has one shape on all of them.  So every exit is zero-padded to the
elementwise-largest cut shape of its direction (the template), and the
receiving band slices its entry back to its entry cut's true shapes: the
padding never enters a contraction.  The true shapes come from one pass of
the zips over meta tensors (`relay_templates`), which computes nothing.

**Ring plans** (periodic column quotients) relax instead: each band seeds
its entry cut from the BP messages (`BMPSEngine._ring_init`, zero-embedded
in the stable entry shapes), then ``max(ring_iters, 1) * D`` steps, in each
of which every band zips its columns from the entry it holds and sends the
exit around the ring, wind every message `ring_iters` times around it.  The
stable entry shapes are the fixed point of the meta pass from the seeds.
These are the JAX package's sharded values, which differ from the
unsharded `_relax_ring` by the winding's decay (the seeds differ).

**Samples** (`ShardedSampler`).  The norm boundaries do not depend on the
sample, so every rank computes them; rank r draws the samples of global
indices ``r w ... r w + w - 1``, ``w = ceil(nsamples / D)``, from their own
uniforms (`BMPSSampler.uniforms(seed, s, nv)`), so a sample's bits do not
depend on D; `mesh.all_gather` collects bits, log q and p/q.

Every rank passes the same engine (graph, options and state) and gets the
same result.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..bmps_engine import BMPSEngine, BMPSSampler
from .mesh import Mesh, all_gather, ppermute


def band_bounds(n_columns: int, n_bands: int) -> list:
    """[(first column, one past the last)] of `n_bands` contiguous bands,
    the first ``n_columns % n_bands`` one column wider
    (`tnqs/parallel/bmps_ring.py:87-90`)."""
    if n_columns < n_bands:
        raise ValueError(f"need >= 1 column per device ({n_columns} columns, {n_bands} devices)")
    base, rem = divmod(n_columns, n_bands)
    starts = np.cumsum([0] + [base + (1 if i < rem else 0) for i in range(n_bands)]).tolist()
    return [(starts[i], starts[i + 1]) for i in range(n_bands)]


@dataclass
class RelayTemplate:
    """One direction's relay: every sent cut is `n` tensors of `shape`
    (zero-padded), and `cuts` holds the true shapes of each cut a band
    takes as its entry: by cut index on line plans, by band on ring
    plans."""

    n: int
    shape: tuple
    cuts: dict

    @property
    def numel(self) -> int:
        return self.n * int(np.prod(self.shape))


def _template(cuts: dict) -> RelayTemplate:
    shapes = [s for cut in cuts.values() for s in cut]
    return RelayTemplate(max(len(cut) for cut in cuts.values()), tuple(max(s[i] for s in shapes) for i in range(4)),
                         cuts)


def _meta(bmps: BMPSEngine):
    """(a copy of `bmps` on meta tensors, the engine's T on meta): its zips
    give the shapes and compute nothing, and it draws no sketch."""
    eng = bmps.engine
    meta = copy.copy(bmps)
    meta.engine = SimpleNamespace(device=torch.device("meta"), plan=eng.plan)
    meta._sketch = lambda code, shape: torch.empty(shape, dtype=eng.dtype, device="meta")
    meta._sketch_cache, meta.sketch_bytes = None, 0
    return meta, {k: torch.empty_like(v, device="meta") for k, v in eng.T.items()}


def _shapes(cut) -> list:
    return [tuple(t.shape) for t in cut]


def relay_templates(bmps: BMPSEngine, n_bands: int) -> tuple:
    """(left, right) `RelayTemplate`s of `bmps`'s relay over `n_bands`
    bands, from the zips on meta tensors (no process group, no compute;
    `tnqs/parallel/bmps_ring.py:96-146`, `:174-249`).

    Line plans: the cuts of the two whole chains (the left chain's exit of
    column c lives on cut c, the right chain's on cut c-1).  Ring plans: the
    stable entry shapes of each band, iterating the band zips from the BP
    product-MPS seeds until the shapes repeat; `RuntimeError` if they have
    not in 8 windings."""
    meta, T = _meta(bmps)
    cp = bmps.cplan
    nC = len(cp.columns)
    if not cp.periodic:
        cutsL, cutsR = {}, {}
        cur = []
        for c in range(nC - 1):
            cur, _ = meta._zip_column(T, c, cur, +1)
            cutsL[c] = _shapes(cur)
        cur = []
        for c in range(nC - 1, 0, -1):
            cur, _ = meta._zip_column(T, c, cur, -1)
            cutsR[c - 1] = _shapes(cur)
        return _template(cutsL), _template(cutsR)
    bands = band_bounds(nC, n_bands)
    chi = bmps.engine.M.shape[-1]
    dt = bmps.engine.dtype

    def stable(direction):
        seed = torch.empty((1, chi, chi, 1), dtype=dt, device="meta")
        entries = [[seed] * len(cp.cross[_entry_cut(b, direction, nC)]) for b in bands]
        for _ in range(8):
            exits = [_band_chain(meta, T, b, entry, direction)[1] for b, entry in zip(bands, entries)]
            new = [exits[(i - direction) % n_bands] for i in range(n_bands)]
            if [_shapes(a) for a in new] == [_shapes(a) for a in entries]:
                return {i: _shapes(e) for i, e in enumerate(new)}
            entries = new
        raise RuntimeError("ring relay cut shapes did not stabilize in 8 windings")

    return _template(stable(+1)), _template(stable(-1))


def _entry_cut(band: tuple, direction: int, nC: int) -> int:
    """The cut a band's entry lives on: the one left of its first column for
    the left chain, right of its last for the right chain (mod nC)."""
    return (band[0] - 1) % nC if direction > 0 else (band[1] - 1) % nC


def _band_chain(bmps, T, band, entry, direction, exit_too=True):
    """The chain `entry` zipped through `band` in `direction`: ({column: the
    cut entering it}, the band's exit, zipped through its last column, or
    None without `exit_too`), the zips of `BMPSEngine._boundary_mpses`."""
    s0, s1 = band
    cols = list(range(s0, s1)) if direction > 0 else list(range(s1 - 1, s0 - 1, -1))
    into, cur = {}, list(entry)
    for i, c in enumerate(cols):
        into[c] = cur
        if i < len(cols) - 1 or exit_too:
            cur, _ = bmps._zip_column(T, c, cur, direction)
    return into, (cur if exit_too else None)


def _pack(cut: list, tmpl: RelayTemplate, like: torch.Tensor) -> torch.Tensor:
    """The cut zero-padded to the template, as one flat buffer
    (`tnqs/parallel/bmps_ring.py:148-161`)."""
    buf = like.new_zeros((tmpl.n,) + tmpl.shape)
    for i, x in enumerate(cut):
        buf[i][tuple(slice(0, s) for s in x.shape)] = x
    return buf.reshape(-1)


def _unpack(buf: torch.Tensor, tmpl: RelayTemplate, shapes: list) -> list:
    """The cut of true `shapes` out of a relayed buffer
    (`tnqs/parallel/bmps_ring.py:163-171`)."""
    padded = buf.reshape((tmpl.n,) + tmpl.shape)
    return [padded[i][tuple(slice(0, s) for s in shape)] for i, shape in enumerate(shapes)]


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    here = torch.cuda.current_device()
    return (here if a.index is None else a.index) == (here if b.index is None else b.index)


class ShardedBMPS:
    """`BMPSEngine`'s column sweep banded over a mesh, one band a rank (see
    the module docstring; `tnqs/parallel/bmps_ring.py:50`).  Needs at least
    one column a rank and the engine on the mesh's device."""

    def __init__(self, bmps: BMPSEngine, mesh: Mesh):
        if not _same_device(mesh.device, bmps.engine.device):
            raise ValueError(f"ShardedBMPS: the engine is on {bmps.engine.device}, the mesh's rank on {mesh.device}")
        self.bmps, self.mesh = bmps, mesh
        self.D = mesh.size
        self.periodic = bool(bmps.cplan.periodic)
        self.nC = len(bmps.cplan.columns)
        self.bands = band_bounds(self.nC, self.D)
        self._templates = None

    def templates(self) -> tuple:
        """(left, right) `RelayTemplate`s, computed once."""
        if self._templates is None:
            self._templates = relay_templates(self.bmps, self.D)
        return self._templates

    def relay_bytes(self) -> dict:
        """What the relay sends: the bytes a rank sends each way a step (its
        padded buffer), the steps, and their product summed over both
        directions."""
        tL, tR = self.templates()
        item = torch.empty((), dtype=self.bmps.engine.dtype).element_size()
        steps = max(self.bmps.ring_iters, 1) * self.D if self.periodic else self.D - 1
        return {"left_bytes": tL.numel * item, "right_bytes": tR.numel * item, "steps": steps,
                "total_bytes": (tL.numel + tR.numel) * item * steps}

    def _shift(self, buf: torch.Tensor, perm: list) -> torch.Tensor:
        # one rank: the ring's only pair sends a rank its own buffer
        return buf if self.D == 1 else ppermute(buf, self.mesh, perm)

    def _entry(self, buf, tmpl: RelayTemplate, key):
        """The chain a band enters with: empty at a line plan's outer edge
        (and on one rank, which relays nothing), else the relayed buffer
        cut back to its true shapes."""
        return [] if buf is None or key not in tmpl.cuts else _unpack(buf, tmpl, tmpl.cuts[key])

    def _line_chains(self, T):
        """(lefts, rights) of this rank's columns after the D-1 relay steps."""
        r, D, nC = self.mesh.rank, self.D, self.nC
        band = s0, s1 = self.bands[r]
        eL = eR = lefts = rights = None
        tL, tR = self.templates() if D > 1 else (None, None)  # one rank relays nothing
        like = T[next(iter(T))]
        fwd = [(i, i + 1) for i in range(D - 1)]
        bwd = [(i + 1, i) for i in range(D - 1)]
        if D > 1:  # what a rank sends before its entry is exact
            sendL, sendR = like.new_zeros(tL.numel), like.new_zeros(tR.numel)
        for t in range(D - 1):
            if lefts is None and t >= r and s1 < nC:  # the entry became exact at step r - 1
                lefts, out = _band_chain(self.bmps, T, band, self._entry(eL, tL, s0 - 1), +1)
                sendL = _pack(out, tL, like)
            if rights is None and t >= D - 1 - r and s0 > 0:
                rights, out = _band_chain(self.bmps, T, band, self._entry(eR, tR, s1 - 1), -1)
                sendR = _pack(out, tR, like)
            eL, eR = self._shift(sendL, fwd), self._shift(sendR, bwd)
        if lefts is None:
            lefts, _ = _band_chain(self.bmps, T, band, self._entry(eL, tL, s0 - 1), +1, exit_too=False)
        if rights is None:
            rights, _ = _band_chain(self.bmps, T, band, self._entry(eR, tR, s1 - 1), -1, exit_too=False)
        return lefts, rights

    def _ring_chains(self, T, M):
        """(lefts, rights) of this rank's columns after the banded
        Gauss-Seidel relay (`tnqs/parallel/bmps_ring.py:251-371`)."""
        bmps, cp, r, D = self.bmps, self.bmps.cplan, self.mesh.rank, self.D
        band = self.bands[r]
        tL, tR = self.templates()
        like = T[next(iter(T))]
        fwd = [(i, (i + 1) % D) for i in range(D)]
        bwd = [(i, (i - 1) % D) for i in range(D)]
        eL = _pack(bmps._ring_init(cp.cross[_entry_cut(band, +1, self.nC)], False, M), tL, like)
        eR = _pack(bmps._ring_init(cp.cross[_entry_cut(band, -1, self.nC)], True, M), tR, like)
        for _ in range(max(bmps.ring_iters, 1) * D):
            outL = _band_chain(bmps, T, band, self._entry(eL, tL, r), +1)[1]
            outR = _band_chain(bmps, T, band, self._entry(eR, tR, r), -1)[1]
            eL, eR = self._shift(_pack(outL, tL, like), fwd), self._shift(_pack(outR, tR, like), bwd)
        lefts, _ = _band_chain(bmps, T, band, self._entry(eL, tL, r), +1, exit_too=False)
        rights, _ = _band_chain(bmps, T, band, self._entry(eR, tR, r), -1, exit_too=False)
        return lefts, rights

    def expect_1site(self, opname: str) -> dict:
        """{vertex: complex} <op_v> for every vertex, the same on every rank
        (`tnqs/parallel/bmps_ring.py:480`): this rank's band through the
        relay and its ladders, every band's values by `all_gather`, in band
        order."""
        bmps, cp = self.bmps, self.bmps.cplan
        eng = bmps.engine
        s0, s1 = self.bands[self.mesh.rank]
        counts = [sum(len(cp.columns[c]) for c in range(a, b)) for a, b in self.bands]
        with torch.no_grad():
            lefts, rights = self._ring_chains(eng.T, eng.M) if self.periodic else self._line_chains(eng.T)
            op = bmps._op(opname)
            vals = []
            for c in range(s0, s1):
                got = bmps._ladder_expect(eng.T, c, lefts[c], rights[c], op)
                vals.extend(got[v] for v in cp.columns[c])
            vals = torch.stack(vals)
            vals = torch.cat([vals, vals.new_zeros(max(counts) - vals.shape[0])])
            host = all_gather(vals, self.mesh).cpu().numpy()  # [D, max(counts)]
        order = [v for a, b in self.bands for c in range(a, b) for v in cp.columns[c]]
        flat = [complex(host[i, j]) for i, n in enumerate(counts) for j in range(n)]
        return dict(zip(order, flat))


class ShardedSampler:
    """`BMPSSampler.sample_directly_certified` with its samples divided
    among the ranks (see the module docstring;
    `tnqs/parallel/bmps_ring.py:512`)."""

    def __init__(self, sampler: BMPSSampler, mesh: Mesh):
        if not _same_device(mesh.device, sampler.bmps.engine.device):
            raise ValueError(f"ShardedSampler: the engine is on {sampler.bmps.engine.device}, the mesh's rank on "
                             f"{mesh.device}")
        self.sampler, self.mesh = sampler, mesh

    def sample_directly_certified(self, nsamples: int, seed: int = 0) -> list:
        """`nsamples` samples with their p/q certificates, the same list on
        every rank: rank r sweeps samples ``r w ... r w + w - 1`` in one
        group of ``w = ceil(nsamples / D)`` lanes (the last rank's past
        `nsamples` are dropped), on the norm boundaries each rank computes."""
        sam, mesh = self.sampler, self.mesh
        D, r = mesh.size, mesh.rank
        w = -(-int(nsamples) // D)
        nv = len(sam.keys_order)
        u = torch.stack([sam.uniforms(seed, s, nv) for s in range(r * w, (r + 1) * w)]).to(sam.bmps.engine.device)
        with torch.no_grad():
            with sam.bmps.sketches_cached():
                norm = sam._norm()
                bits, logq, poverq = sam._group(norm, u, sam._lane_budget(w))
            bits = all_gather(bits, mesh).reshape(D * w, nv)[:nsamples].cpu().numpy()
            vals = all_gather(torch.stack([logq, poverq]), mesh).permute(1, 0, 2).reshape(2, D * w)
            logq, poverq = vals[:, :nsamples].cpu().numpy()
            n_hat = float(torch.exp(norm[3] - norm[2]).cpu())
        return [dict(poverq=float(poverq[s]), logq=float(logq[s]), norm_estimate=n_hat,
                     bitstring={v: int(bits[s, i]) for i, v in enumerate(sam.keys_order)})
                for s in range(nsamples)]
