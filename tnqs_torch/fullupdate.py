"""Full update: variational gate application against arbitrary environments
(port of `tnqs/fullupdate.py`).

The two site tensors are QR-reduced and the reduced tensors optimized by
ALS sweeps, each solving the normal equations of one of them: matrix-free
BiCGSTAB on the device for systems past 256 unknowns, a dense min-norm
solve below it or where BiCGSTAB stalls (up to 4096).  Used by the
boundary-MPS truncation (`truncate.truncate_bmps_cache`).

Host reads: BiCGSTAB's breakdown and convergence tests read one device
scalar each (up to five an iteration, and one for ``|b| == 0``); the dense
solve reads nothing.  `core.linalg.host_reads` counts both.  `solves`
counts the solves by the route that produced the answer.
"""

from __future__ import annotations

import warnings
from collections import Counter
from math import prod

import numpy as np
import torch

from .contraction import contract, contraction_sequence
from .core import linalg
from .core.linalg import factorize, factorize_svd
from .core.tensor import Tensor, commoninds, uniqueinds

# solves by route: "dense" (n <= 256), "bicgstab" (converged, or stalled past
# n = 4096), "bicgstab->dense" (stalled, then solved densely)
solves: Counter = Counter()


def _read(x: torch.Tensor):
    """One device scalar on the host (a Python float or complex), counted as
    a host read."""
    linalg.host_reads.count += 1
    return x.item()


def _min_norm_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The min-norm least-squares solution of ``A x = b`` on A's device:
    numpy's ``lstsq(rcond=None)`` (an SVD solve treating singular values at
    or below eps * max(m, n) * s_max as zero).  `torch.linalg.lstsq` has only
    the QR driver `gels` on CUDA, which assumes full rank."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(s.dtype).eps * max(A.shape)
    keep = s > rcond * s[:1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return Vh.mH @ (s_inv.to(A.dtype) * (U.mH @ b))


def _greedy(ts) -> list:
    return contraction_sequence(ts, alg="greedy")


def _greedy_planner():
    """`_greedy`, remembered by the networks' index lists: the ALS sweeps
    contract the same networks, with new data, sweep after sweep."""
    seqs = {}

    def plan(ts) -> list:
        key = tuple(t.inds for t in ts)
        if key not in seqs:
            seqs[key] = _greedy(ts)
        return seqs[key]

    return plan


def _solve(tensors_fixed, b: Tensor, x0: Tensor, tol: float = 1e-10, maxiter: int = 200, plan=_greedy) -> Tensor:
    """Solve ``M x = b``, M the linear map ``x -> noprime(contract(fixed, x))``
    (`tnqs/fullupdate.py:17`): the dense min-norm solve for n <= 256, else
    BiCGSTAB from `x0` with the map applied by contraction (sequence planned
    once), falling back to the dense solve when it stalls (n <= 4096) and
    warning past that if the residual stays above max(100 tol, 1e-3).
    `plan` gives a network's greedy contraction sequence."""
    inds = list(x0.inds)
    dims = [i.dim for i in inds]
    n = prod(dims)

    def dense_solve() -> Tensor:
        E = contract(tensors_fixed, sequence=plan(tensors_fixed))
        e_cols = [i for i in inds if E.hasind(i)]
        id_inds = [i for i in inds if not E.hasind(i)]
        e_rows = [i.prime() for i in e_cols]
        if not all(E.hasind(r) for r in e_rows) or E.ndim != 2 * len(e_cols):
            raise ValueError("full update: unexpected environment index structure")
        Emat = E.matricize(e_rows, e_cols).contiguous()
        d_id = prod(i.dim for i in id_inds)
        # numpy's promotion, as the reference's np.kron with a float64
        # identity: the solve runs in double at any input precision, and its
        # answer stays double (complex128 for complex64 inputs)
        wide = torch.promote_types(Emat.dtype, torch.float64)
        Mmat = torch.kron(Emat.to(wide), torch.eye(d_id, dtype=wide, device=Emat.device))
        order = e_cols + id_inds
        b_arr = b.permute(order).data.reshape(-1)
        dt = torch.promote_types(Mmat.dtype, b_arr.dtype)
        sol = _min_norm_solve(Mmat.to(dt), b_arr.to(dt))
        return Tensor(sol.reshape([i.dim for i in order]), order).permute(inds)

    if n <= 256:
        # small systems: the exact min-norm solve is cheaper than iterating
        solves["dense"] += 1
        return dense_solve()

    # planned once, and only here: the dense solve contracts the environment alone
    x_probe = x0.sim_inds_like(x0) if hasattr(x0, "sim_inds_like") else x0
    seq = plan(list(tensors_fixed) + [x_probe])

    def apply_M(vec: torch.Tensor) -> torch.Tensor:
        xt = Tensor(vec.reshape(dims), inds)
        out = contract(list(tensors_fixed) + [xt], sequence=seq).noprime()
        return out.permute(inds).data.reshape(-1)

    b_arr = b.permute(inds).data.reshape(-1)
    x = x0.permute(inds).data.reshape(-1).to(b_arr.dtype).clone()
    bnorm = _read(torch.linalg.vector_norm(b_arr))
    if bnorm == 0:
        solves["bicgstab"] += 1
        return Tensor(torch.zeros_like(b_arr).reshape(dims), inds)

    # BiCGSTAB (templates version), complex-safe; the iterate and its
    # scalars stay on the device, each test reads one scalar
    r = b_arr - apply_M(x)
    r_hat = r.clone()
    rho = alpha = omega = torch.ones((), dtype=b_arr.dtype, device=b_arr.device)
    rho_host = 1.0 + 0.0j
    v = p = torch.zeros_like(r)
    converged = False
    for _ in range(maxiter):
        rho_new = torch.vdot(r_hat, r)
        rho_new_host = _read(rho_new)
        if abs(rho_new_host) < 1e-300:
            break
        beta = (rho_new / rho) * (alpha / omega) if rho_host != 0 else 0.0
        rho, rho_host = rho_new, rho_new_host
        p = r + beta * (p - omega * v)
        v = apply_M(p)
        denom = torch.vdot(r_hat, v)
        if abs(_read(denom)) < 1e-300:
            break
        alpha = rho / denom
        s = r - alpha * v
        if _read(torch.linalg.vector_norm(s)) <= tol * bnorm:
            x = x + alpha * p
            converged = True
            break
        t = apply_M(s)
        tt = torch.vdot(t, t)
        if abs(_read(tt)) < 1e-300:
            break
        omega = torch.vdot(t, s) / tt
        x = x + alpha * p + omega * s
        r = s - omega * t
        if _read(torch.linalg.vector_norm(r)) <= tol * bnorm:
            converged = True
            break

    if not converged:
        if n <= 4096:
            solves["bicgstab->dense"] += 1
            return dense_solve()
        # too large for the dense fallback: surface stagnation instead of
        # silently returning a degraded iterate (near-singular BP
        # environments can stall BiCGSTAB)
        resid = _read(torch.linalg.vector_norm(b_arr - apply_M(x))) / bnorm
        if resid > max(100.0 * tol, 1e-3):
            warnings.warn(
                f"full update: BiCGSTAB stagnated at relative residual "
                f"{resid:.2e} (n={n}, tol={tol:.1e}); the updated tensor may "
                "be degraded — consider raising nfullupdatesweeps or maxiter",
                RuntimeWarning,
                stacklevel=2,
            )
    solves["bicgstab"] += 1
    return Tensor(x.reshape(dims), inds)


def full_update(o: Tensor, psi, vv, envs, nfullupdatesweeps: int = 10, symmetrize: bool = False,
                maxdim: int | None = None, cutoff: float | None = None, **kwargs):
    """Variational two-site gate application (`tnqs/fullupdate.py:126`):
    the two updated site tensors, on the state's device."""
    v1, v2 = vv
    t1, t2 = psi[v1], psi[v2]
    dangling1 = psi.uniqueinds(v1)
    dangling2 = psi.uniqueinds(v2)
    q1_inds = [i for i in uniqueinds(t1, t2) if i not in dangling1]
    q2_inds = [i for i in uniqueinds(t2, t1) if i not in dangling2]
    Q1, R1 = factorize(t1, q1_inds, ortho="left")
    Q2, R2 = factorize(t2, q2_inds, ortho="left")

    extended_envs = list(envs) + [Q1, Q1.prime().dag(), Q2, Q2.prime().dag()]
    R1n, R2n = _optimise_p_q(R1, R2, extended_envs, o, nfullupdatesweeps=nfullupdatesweeps, maxdim=maxdim,
                             cutoff=cutoff)
    if symmetrize:
        R1n, R2n, _, _ = factorize_svd(R1n * R2n, list(R1n.inds), maxdim=maxdim, cutoff=cutoff, ortho="none")
    return Q1 * R1n, Q2 * R2n


def _optimise_p_q(p, q, envs, o, nfullupdatesweeps=10, maxdim=None, cutoff=None):
    """ALS optimization of the reduced tensors (`tnqs/fullupdate.py:158`)."""
    oR = (o * (p * q)).noprime()
    keep = [i for i in p.inds if oR.hasind(i)]
    p_cur, q_cur = factorize(oR, keep, ortho="left", maxdim=maxdim, cutoff=cutoff)

    env_inds = set()
    for e in envs:
        env_inds.update(e.inds)
    qs_ind = [i for i in q_cur.inds if i not in env_inds and not p_cur.hasind(i)]
    ps_ind = [i for i in p_cur.inds if i not in env_inds and not q_cur.hasind(i)]

    plan = _greedy_planner()

    def b_vec(r):
        ts = [p, q, o, r.prime().dag()] + envs
        return contract(ts, sequence=plan(ts)).noprime()

    def m_fixed(pq_tensor, s_ind):
        bra = pq_tensor.prime().dag().replaceinds([i.prime() for i in s_ind], list(s_ind))
        return [pq_tensor, bra] + envs

    for _ in range(nfullupdatesweeps):
        p_cur = _solve(m_fixed(q_cur, qs_ind), b_vec(q_cur), p_cur, plan=plan)
        q_cur = _solve(m_fixed(p_cur, ps_ind), b_vec(p_cur), q_cur, plan=plan)
    return p_cur, q_cur


def fidelity(envs, p_cur, q_cur, p_prev, q_prev, gate) -> float:
    """Squared overlap cost of the full-update optimization
    (`tnqs/fullupdate.py:190`); reads three scalars to the host."""
    p_sind = commoninds(p_cur, gate)[0]
    q_sind = commoninds(q_cur, gate)[0]
    p_sim, q_sim = p_sind.sim(), q_sind.sim()
    gate_sq = gate * gate.dag().replaceinds([p_sind, q_sind], [p_sim, q_sim])
    t1 = [
        p_prev,
        q_prev,
        p_prev.prime().dag().replaceind(p_sind.prime(), p_sim),
        q_prev.prime().dag().replaceind(q_sind.prime(), q_sim),
        gate_sq,
    ] + list(envs)
    term1 = contract(t1, sequence=contraction_sequence(t1, alg="optimal")).item()
    t2 = [
        p_cur,
        q_cur,
        p_cur.prime().dag().replaceind(p_sind.prime(), p_sind),
        q_cur.prime().dag().replaceind(q_sind.prime(), q_sind),
    ] + list(envs)
    term2 = contract(t2, sequence=contraction_sequence(t2, alg="optimal")).item()
    t3 = [p_prev, q_prev, p_cur.prime().dag(), q_cur.prime().dag(), gate] + list(envs)
    term3 = contract(t3, sequence=contraction_sequence(t3, alg="optimal")).item()
    f = term3 / np.sqrt(term1 * term2)
    return abs(f) ** 2
