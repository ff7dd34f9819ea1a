"""tnqs_torch.fullupdate against tnqs.fullupdate on the CPU: the solve on
both of its routes (the dense min-norm solve, a singular environment
included, and BiCGSTAB past 256 unknowns, with its fallback), the full
update of `tests/test_gauge_measure.py:79` and the fidelity, all at
complex128 on numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import tnqs
from tnqs import fullupdate as jfu
from tnqs.core.index import Index as JIndex
from tnqs.core.tensor import Tensor as JTensor

import tnqs_torch as tt
from tnqs_torch import fullupdate as pfu
from tnqs_torch.core import linalg as plinalg
from tnqs_torch.core.index import Index as PIndex
from tnqs_torch.core.tensor import Tensor as PTensor

from torch_flex_cases import CPU, graph, pair_states

torch.set_num_threads(1)


def _solve_case(dims, rank, seed, shift=0.0):
    """x(a, b, s) and the environment E(a', b', a, b) = A A^H / m + shift (1
    + 0.1 R / sqrt(m)), m = dim a * dim b, with A of the given rank (a
    singular environment when rank < m and shift = 0), and b(a, b, s), in
    both packages on the same arrays."""
    rng = np.random.default_rng(seed)
    da, db, ds = dims
    m = da * db
    A = rng.standard_normal((m, rank)) + 1j * rng.standard_normal((m, rank))
    R = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    E = (A @ A.conj().T / m + shift * (np.eye(m) + 0.1 * R / np.sqrt(m))).reshape(da, db, da, db)
    b = rng.standard_normal(dims) + 1j * rng.standard_normal(dims)
    x0 = rng.standard_normal(dims) + 1j * rng.standard_normal(dims)
    out = []
    for Index, Tensor, kw in ((JIndex, JTensor, {}), (PIndex, PTensor, {"device": CPU})):
        a, bb, s = Index(da, "a"), Index(db, "b"), Index(ds, "s")
        inds = [a, bb, s]
        fixed = [Tensor(E, [a.prime(), bb.prime(), a, bb], **kw)]
        out.append((fixed, Tensor(b, inds, **kw), Tensor(x0, inds, **kw)))
    return out, E.reshape(m, m), b


@pytest.mark.parametrize("dims,rank", [((4, 3, 2), 12), ((4, 3, 2), 5), ((3, 3, 4), 2)])
def test_dense_solve_matches_jax_min_norm(dims, rank):
    """n <= 256: the dense solve, on a full-rank and on singular environments
    (rank 5 and 2 of 12 and 9), where the min-norm solution is the one
    numpy's lstsq gives: port against JAX within 1e-10 and against the
    pseudo-inverse's solution."""
    (jcase, pcase), E, b = _solve_case(dims, rank, seed=rank)
    before = pfu.solves["dense"]
    xj = np.asarray(jfu._solve(*jcase).data)
    xp = pfu._solve(*pcase).to_numpy()
    assert pfu.solves["dense"] == before + 1
    scale = np.abs(xj).max()
    assert np.abs(xj - xp).max() < 1e-10 * scale
    # the min-norm solution of (E kron I) x = b
    ref = np.einsum("ij,js->is", np.linalg.pinv(E), b.reshape(E.shape[0], -1)).reshape(dims)
    assert np.abs(xp - ref).max() < 1e-10 * scale
    if rank < E.shape[0]:
        # a singular environment: a null-space vector added keeps the residual
        # and changes the solution
        null = np.linalg.svd(E)[2][-1].conj()
        other = xp + np.einsum("i,s->is", null, np.ones(dims[-1])).reshape(dims)
        res = lambda x: np.abs(np.einsum("ij,js->is", E, x.reshape(E.shape[0], -1)) - b.reshape(E.shape[0], -1)).max()  # noqa: E731
        assert abs(res(other) - res(xp)) < 1e-8 * max(1.0, res(xp))
        assert np.abs(other - xp).max() > 0.1


def _complex64_case(spectrum, seed):
    """x(a, b, s) at dims (4, 3, 2) against the environment E = U diag(
    spectrum) U^H (U a seeded 12 x 12 unitary) and b, all cast to complex64,
    in both packages on the same arrays."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12)))
    E = ((U * np.asarray(spectrum)) @ U.conj().T).astype(np.complex64).reshape(4, 3, 4, 3)
    b = (rng.standard_normal((4, 3, 2)) + 1j * rng.standard_normal((4, 3, 2))).astype(np.complex64)
    out = []
    for Index, Tensor, kw in ((JIndex, JTensor, {}), (PIndex, PTensor, {"device": CPU})):
        a, bb, s = Index(4, "a"), Index(3, "b"), Index(2, "s")
        inds = [a, bb, s]
        out.append(([Tensor(E, [a.prime(), bb.prime(), a, bb], **kw)], Tensor(b, inds, **kw),
                    Tensor(np.zeros_like(b), inds, **kw)))
    return out


# a full-rank environment, and the singular one whose spectrum runs down to
# 1e-12: float32's cutoff (eps * 12 * s_max ~ 1.4e-6) drops four directions
# that float64's (~2.7e-15) inverts
SPECTRA = {"full_rank": np.geomspace(1.0, 1e-2, 12),
           "singular": [1.0] * 6 + [1e-4, 1e-5, 1e-6, 1e-7, 1e-9, 1e-12]}


@pytest.mark.parametrize("name", sorted(SPECTRA))
def test_dense_solve_at_complex64_matches_jax(name):
    """complex64 inputs: the dense solve runs in double as numpy's promotion
    makes the reference's (`np.kron` with a float64 identity, `lstsq` with
    float64's cutoff) and answers complex128, as JAX's does.  Port against
    JAX within 1e-10 of the answer's scale on the full-rank environment, and
    within 1e-3 on the singular one, where the 1e-12 direction's condition
    number (1e12) amplifies the two LAPACKs' double rounding; a float32
    cutoff would be 100% off there (its max |x| ~1e5 against ~1e8)."""
    jcase, pcase = _complex64_case(SPECTRA[name], seed=3)
    xj = np.asarray(jfu._solve(*jcase).data)
    xp = pfu._solve(*pcase)
    assert xj.dtype == np.complex128 and xp.data.dtype == torch.complex128
    xp = xp.to_numpy()
    scale = np.abs(xj).max()
    if name == "singular":
        assert scale > 1e7
    assert np.abs(xj - xp).max() < (1e-10 if name == "full_rank" else 1e-3) * scale


def test_bicgstab_matches_jax_and_counts_host_reads():
    """n = 512 > 256: BiCGSTAB on a well-conditioned, mildly non-hermitian
    environment, port against JAX within 1e-10; every test of the iteration
    is one counted host read."""
    (jcase, pcase), E, b = _solve_case((16, 8, 4), 128, seed=7, shift=1.0)
    before, reads = dict(pfu.solves), plinalg.host_reads.count
    xj = np.asarray(jfu._solve(*jcase).data)
    xp = pfu._solve(*pcase).to_numpy()
    assert pfu.solves["bicgstab"] == before.get("bicgstab", 0) + 1
    assert pfu.solves["dense"] == before.get("dense", 0)
    reads = plinalg.host_reads.count - reads
    assert 3 <= reads <= 1 + 5 * 200
    assert np.abs(xj - xp).max() < 1e-10 * np.abs(xj).max()


def test_bicgstab_stall_falls_back_to_the_dense_solve():
    """BiCGSTAB cut after one iteration does not converge: for n <= 4096 both
    packages answer by the dense min-norm solve, within 1e-10."""
    (jcase, pcase), _, _ = _solve_case((16, 8, 4), 128, seed=8, shift=1.0)
    before = pfu.solves["bicgstab->dense"]
    xj = np.asarray(jfu._solve(*jcase, maxiter=1).data)
    xp = pfu._solve(*pcase, maxiter=1).to_numpy()
    assert pfu.solves["bicgstab->dense"] == before + 1
    assert np.abs(xj - xp).max() < 1e-10 * np.abs(xj).max()


@pytest.fixture(scope="module")
def path_case():
    """`tests/test_gauge_measure.py:79`'s case in both packages: a random
    chi=2 complex128 state on a 2-site path, Rzz(0.37), BP environments;
    JAX's full update (20 sweeps) and simple update."""
    g = tnqs.named_path_graph(2)
    psij, psip, imap = pair_states(g, 2, np.complex128, 11)
    gj, _ = tnqs.to_tensor(("Rzz", [1, 2], 0.37), g, psij.siteinds())
    envj = tnqs.BeliefPropagationCache(psij).update().incoming_messages([1, 2])
    fuj = tnqs.full_update(gj, psij, [1, 2], envs=envj, maxdim=8, nfullupdatesweeps=20)
    return g, psij, psip, imap, fuj


def test_full_update_matches_simple_update_and_jax(path_case):
    """The port's full update against its simple update (normalized overlap
    within 1e-8, as the JAX test) and against JAX's full update by the
    gauge-invariant overlap of the two-site states within 1e-10."""
    g, psij, psip, imap, (t1j, t2j) = path_case
    gp = tt.to_tensor(("Rzz", [1, 2], 0.37), graph(g), psip.siteinds(), device=CPU)[0]
    envp = tt.BeliefPropagationCache(psip).update().incoming_messages([1, 2])
    (s1, s2), _, _ = tt.simple_update(gp, [psip[1], psip[2]], envs=envp, maxdim=8)
    t1p, t2p = tt.full_update(gp, psip, [1, 2], envs=envp, maxdim=8, nfullupdatesweeps=20)
    assert t1p.device == torch.device(CPU)
    su, fu = psip.copy(), psip.copy()
    su[1], su[2], fu[1], fu[2] = s1, s2, t1p, t2p
    num = tt.inner(su, fu, alg="exact")
    den = np.sqrt(abs(tt.norm_sqr(su, alg="exact")) * abs(tt.norm_sqr(fu, alg="exact")))
    assert abs(abs(num) / den - 1.0) < 1e-8
    # port against JAX: the two-site states over the site indices
    sites_p = [psip.siteinds(1)[0], psip.siteinds(2)[0]]
    vp = (t1p * t2p).permute(sites_p).to_numpy()
    wj = t1j * t2j
    vj = imap.array(wj, (t1p * t2p).permute(sites_p))
    ov = abs(np.vdot(vj, vp)) / (np.linalg.norm(vj) * np.linalg.norm(vp))
    assert abs(ov - 1.0) < 1e-10


def test_fidelity_matches_jax():
    """`fidelity` of a full update that truncates (maxdim 2 on the middle
    bond of a 4-site path, whose Schmidt rank the gate takes to 4; BP
    environments on the outer bonds), port against JAX within 1e-12."""
    g = tnqs.named_path_graph(4)
    psij, psip, _ = pair_states(g, 2, np.complex128, 5)
    gj, _ = tnqs.to_tensor(("Rxx", [2, 3], 0.61), g, psij.siteinds())
    gp, _ = tt.to_tensor(("Rxx", [2, 3], 0.61), graph(g), psip.siteinds(), device=CPU)
    envj = tnqs.BeliefPropagationCache(psij).update().incoming_messages([2, 3])
    envp = tt.BeliefPropagationCache(psip).update().incoming_messages([2, 3])
    assert len(envp) == len(envj) == 2
    t1j, t2j = tnqs.full_update(gj, psij, [2, 3], envs=envj, maxdim=2)
    t1p, t2p = tt.full_update(gp, psip, [2, 3], envs=envp, maxdim=2)
    fj = jfu.fidelity(envj, t1j, t2j, psij[2], psij[3], gj)
    fp = pfu.fidelity(envp, t1p, t2p, psip[2], psip[3], gp)
    assert 0.5 < fp < 1.0 - 1e-6
    assert abs(fj - fp) < 1e-12
