"""Batched SQP solver — the bit-tolerant device twin of scipy SLSQP.

The reference's solve is scipy SLSQP over 3·control_steps variables
(mpc_optimization_server.py:363-364) with box bounds (py:125-133) and per-step
translational-speed cone constraints r ≥ ‖(vx, vy)_i‖ (py:157-158, :134).
SLSQP is sequential least-squares programming: BFGS curvature + an inequality-
constrained QP subproblem + L1-merit line search. This module implements the
same algorithm family natively in JAX so it converges to the *same KKT points*
(prox methods stall where the cone is active — see solver.py), while being pure,
static-shaped, and vmap/pjit-batchable:

- gradients are analytic (jax.grad of the fused objective) instead of scipy's
  3N+1-evaluation forward differences;
- the QP subproblem  min ½dᵀBd + gᵀd  s.t. lo ≤ x+d ≤ hi, c + Jd ≥ 0  is
  solved by an OSQP-style ADMM (fixed iteration count, one small Cholesky
  factorization per outer step; batched over scenarios on a GPU the whole QP
  is one fused kernel, `_qp_admm_triton`);
- damped BFGS (Powell's modification) keeps B positive definite;
- an L1 exact-penalty merit function with Armijo backtracking globalizes;
- termination mirrors SLSQP's |f_k − f_{k−1}| < ftol criterion, plus
  line-search failure (how SLSQP effectively stops at the nonsmooth
  control-cost kink, where the objective has a subdifferential cone).

All loops are `lax.while_loop`/`lax.scan` with static bounds.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .config import MpcConfig
from .solver import SolveResult

__all__ = ["sqp_solve", "make_sqp_solver", "make_sqp_solver_batched"]


def _cone_constraints(x: jnp.ndarray, cfg: MpcConfig, max_vel_trans=None):
    """c_i(x) = max_vel_trans − ‖(vx, vy)_i‖ ≥ 0 and its Jacobian J (N, 3N).

    At xy = 0 the constraint is inactive (c = r > 0) and the true Jacobian is
    undefined; a zero row is safe there.
    """
    n = cfg.control_steps
    r = cfg.max_vel_trans if max_vel_trans is None else max_vel_trans
    u = x.reshape(n, 3)
    xy = u[:, :2]
    nrm = jnp.sqrt(jnp.sum(xy**2, axis=-1))
    c = r - nrm
    safe = jnp.maximum(nrm, 1e-12)
    dxy = -xy / safe[:, None]
    dxy = jnp.where(nrm[:, None] > 1e-12, dxy, 0.0)
    # Scatter into (N, 3N): row i has dxy[i] at columns 3i, 3i+1.
    J = jnp.zeros((n, 3 * n), x.dtype)
    rows = jnp.arange(n)
    J = J.at[rows, 3 * rows].set(dxy[:, 0])
    J = J.at[rows, 3 * rows + 1].set(dxy[:, 1])
    return c, J


def _tree_sum(terms):
    """Pairwise (tree) summation of a Python list of same-shape arrays.

    The unrolled factorization's accumulations are its critical path: a
    left-to-right fold is depth O(m) per entry, and under vmap every lane
    executes the full chain in lockstep. Pairwise reduction cuts the depth to
    O(log m) at identical op count. Reassociates float adds — same values to
    ~1e-7, which is inside every parity/golden tolerance.
    """
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _chol_factor_unrolled(E, m: int):
    """Fully-unrolled Cholesky factor M = L Lᵀ at scalar granularity via an
    element accessor: E(i, j) returns the (i, j) matrix element (only i >= j
    is read) as an array of any (broadcast-compatible) shape; all arithmetic
    is elementwise on that shape. Returns (L, D): L as an m×m list-of-lists
    of element arrays (lower triangle filled) and D[j] = 1/L[j][j].

    ~m³/6 elementwise ops; the diagonal is carried as its reciprocal square
    root (hardware rsqrt + multiplies), so neither the factor nor the
    substitutions that use it ever divide. Inner dot products are
    tree-summed (_tree_sum) to shorten the dependent chain under lockstep
    vmap.
    """
    tiny = 1e-20

    L = [[None] * m for _ in range(m)]
    D = [None] * m  # 1/L[j][j]
    for j in range(m):
        prods = [L[j][k] * L[j][k] for k in range(j)]
        s = E(j, j) - _tree_sum(prods) if prods else E(j, j)
        s = jnp.maximum(s, tiny)
        D[j] = jax.lax.rsqrt(s)
        L[j][j] = s * D[j]  # == sqrt(s)
        for i in range(j + 1, m):
            prods = [L[i][k] * L[j][k] for k in range(j)]
            si = E(i, j) - _tree_sum(prods) if prods else E(i, j)
            L[i][j] = si * D[j]
    return L, D


def _chol_solve_unrolled(L, D, r):
    """x = M⁻¹ r for M = L Lᵀ (from _chol_factor_unrolled): one forward and
    one backward substitution, ~m² multiply-adds, no divisions. r and the
    result are length-m lists of element arrays."""
    m = len(r)
    y = []
    for i in range(m):
        prods = [L[i][k] * y[k] for k in range(i)]
        y.append((r[i] - _tree_sum(prods) if prods else r[i]) * D[i])
    x = [None] * m
    for i in reversed(range(m)):
        prods = [L[k][i] * x[k] for k in range(i + 1, m)]
        x[i] = (y[i] - _tree_sum(prods) if prods else y[i]) * D[i]
    return x


def _chol_inverse_unrolled(E, m: int):
    """Fully-unrolled SPD inverse at scalar granularity (element accessor E
    as in _chol_factor_unrolled). Returns X as an m×m list-of-lists of
    element arrays.

    The whole inverse unrolls into ~m³/2 elementwise ops. Scalar granularity
    exposes structure a row-vector formulation couldn't: L⁻¹ is lower
    triangular (its c > i entries are skipped, not multiplied through) and
    the result is symmetric (only the lower triangle is back-substituted;
    the upper mirrors it).
    """
    L, D = _chol_factor_unrolled(E, m)
    # Forward: Y = L⁻¹ (lower triangular), entries (i, c) with c ≤ i.
    Y = [[None] * (i + 1) for i in range(m)]
    for i in range(m):
        Y[i][i] = D[i]
        for c in range(i):
            Y[i][c] = -_tree_sum([L[i][k] * Y[k][c]
                                  for k in range(c, i)]) * D[i]
    # Backward: X = M⁻¹ = L⁻ᵀ Y, symmetric — lower triangle only, mirrored.
    X = [[None] * m for _ in range(m)]
    for i in reversed(range(m)):
        for c in range(i + 1):
            prods = [L[k][i] * X[k][c] for k in range(i + 1, m)]
            acc = Y[i][c] - _tree_sum(prods) if prods else Y[i][c]
            X[i][c] = acc * D[i]
            X[c][i] = X[i][c]
    return X


def _chol_inverse_lane_minor(Mt: jnp.ndarray) -> jnp.ndarray:
    """Unrolled SPD inverse on a lane-minor element view: Mt has shape
    (m, m, *batch) so element (i, j) is the (*batch,) vector Mt[i, j].
    Returns the inverse in the same layout."""
    m = Mt.shape[0]
    X = _chol_inverse_unrolled(lambda i, j: Mt[i, j], m)
    flat = jnp.stack([X[i][c] for i in range(m) for c in range(m)], axis=0)
    return flat.reshape((m, m) + Mt.shape[2:])


@jax.custom_batching.custom_vmap
def _chol_inverse(M: jnp.ndarray) -> jnp.ndarray:
    """Exact SPD inverse via fully-unrolled Cholesky + triangular solves.

    m = 3·control_steps is tiny and static, so the whole inverse unrolls into
    fused elementwise vector ops: no solver library call and no launch per
    matrix.

    Under plain vmap every intermediate carries the batch axis LEADING, so
    the unrolled code's per-element reads M[:, i, j] would be stride-m²
    reads across lanes. The custom_vmap rule below instead moves the mapped
    axis minor once — an (m, m, B) element view in which every element is a
    dense (B,) vector — runs the unrolled solve there, and moves it back.
    """
    Mt = jnp.moveaxis(M, (-2, -1), (0, 1))  # (m, m, *batch)
    Xt = _chol_inverse_lane_minor(Mt)
    return jnp.moveaxis(Xt, (0, 1), (-2, -1))


@_chol_inverse.def_vmap
def _chol_inverse_vmap_rule(axis_size, in_batched, M):
    del axis_size, in_batched
    # Mapped axis (0) goes minor, matrix dims major.
    Mt = jnp.moveaxis(M, (-2, -1, 0), (0, 1, M.ndim - 1))
    Xt = _chol_inverse_lane_minor(Mt)
    out = jnp.moveaxis(Xt, (0, 1, Xt.ndim - 1), (-2, -1, 0))
    return out, True


# The solver's float32 products run at full float32 precision. At the
# backend's default a GPU may run a float32 product in TF32 (about three
# decimal digits); these products are tiny and latency-bound, so HIGHEST
# costs nothing measurable, and it keeps the plain path — the kernel's
# reference and the path the scipy-oracle parity gate holds — at float32.
_dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
_vdot = functools.partial(jnp.vdot, precision=jax.lax.Precision.HIGHEST)

# Robot lanes per kernel program (one lane per thread, so block // 32 warps).
# Small programs spread a fleet batch over all SMs: 4096 lanes make 128.
# On the H100, 32 was the fastest of {32, 64, 128} at m=9 (PERF.md).
_QP_BLOCK = 32


def _qp_admm(B, g, x, c, J, cfg: MpcConfig, iters: int, lo, hi, init=None,
             rho: float = 1.0, sigma: float = 1e-6):
    """OSQP-style ADMM for  min ½dᵀBd + gᵀd  s.t.  lo−x ≤ d ≤ hi−x,
    Jd ≥ −c.  Returns (d, y_cone, qp_state): the step, the cone dual
    estimates, and the final ADMM iterate for warm-starting the NEXT QP.

    Constraint stack: z = A d with A = [I; J]; the box part of z lives in
    [lo−x, hi−x], the cone part in [−c, +inf).

    init: previous (d, zb, zc, wb, wc) carry. Warm-starting the splitting
    variables across consecutive SQP subproblems (the OSQP-in-SQP trick — the
    active set stabilizes as the outer iteration converges) raises the
    fixed-iteration-budget QP accuracy enough that the outer loop no longer
    stalls at near-KKT points the reference's SLSQP escapes (cold ADMM at
    qp_iters=60 left ~1e-3 objective gaps on ~8 % of the MPO-700 suite;
    warm-started duals close them at the same budget).
    """
    m = x.shape[0]
    if init is None:
        zeros_m = jnp.zeros_like(x)
        zeros_n = jnp.zeros_like(c)
        init = (zeros_m, zeros_m, zeros_n, zeros_m, zeros_n)
    core = _qp_admm_core(int(iters), float(rho), float(sigma), int(m))
    d_out, y_cone, *carry = core(B.reshape(-1), g, x, c, J,
                                 jnp.broadcast_to(lo, x.shape),
                                 jnp.broadcast_to(hi, x.shape), *init)
    return d_out, y_cone, tuple(carry)


def _qp_admm_plain(Bflat, g, x, c, J, lo, hi, d0, zb0, zc0, wb0, wc0,
                   *, iters: int, rho: float, sigma: float):
    """Unbatched XLA reference path of the ADMM QP (see _qp_admm)."""
    m = x.shape[0]
    dlo = lo - x
    dhi = hi - x

    M = (Bflat.reshape(m, m) + (sigma + rho) * jnp.eye(m, dtype=x.dtype)
         + rho * _dot(J.T, J))
    # Explicit inverse, computed ONCE per QP: the ADMM iterations then reduce
    # to dense matvecs. M is SPD (damped-BFGS B + σI + ρ(I + JᵀJ)).
    Minv = _chol_inverse(M)

    def step(carry, _):
        d, zb, zc, wb, wc = carry
        rhs = -g + sigma * d + rho * (zb - wb) + rho * _dot(J.T, zc - wc)
        d = _dot(Minv, rhs)
        Jd = _dot(J, d)
        zb = jnp.clip(d + wb, dlo, dhi)
        zc = jnp.maximum(Jd + wc, -c)
        wb = wb + d - zb
        wc = wc + Jd - zc
        return (d, zb, zc, wb, wc), None

    carry, _ = jax.lax.scan(step, (d0, zb0, zc0, wb0, wc0), None,
                            length=iters)
    d = carry[0]
    # Final safeguard: clamp the step into the box exactly.
    d_out = jnp.clip(d, dlo, dhi)
    y_cone = rho * carry[4]  # dual estimate for the cone rows
    return (d_out, y_cone) + tuple(carry)


def _qp_admm_kernel(B_ref, g_ref, x_ref, c_ref, dxy_ref, lo_ref, hi_ref,
                    d_ref, zb_ref, zc_ref, wb_ref, wc_ref,
                    dout_ref, dN_ref, zbN_ref, zcN_ref, wbN_ref, wcN_ref,
                    *, iters: int, rho: float, sigma: float, m: int,
                    block: int):
    """Pallas body: the WHOLE QP — Cholesky factor of M plus `iters` ADMM
    iterations — for `block` robot lanes, one lane per thread.

    Operands are the solver's own (B, rows) arrays. Lane b's rows are
    contiguous, so one program's lanes read one contiguous (block, rows)
    tile: the first element load brings it into L1 and the rest hit there.
    Every value below is a (block,) vector held in registers: the m(m+1)/2
    entries of the factor and the ADMM state. The cone Jacobian enters
    through its two nonzeros per row (dxy), so JᵀJ, Jᵀv and Jd are exact
    single-product expressions — the values the dense plain path computes
    (its dot-product sums only add structural zeros).

    Each iteration solves M d = rhs by substitution with the factor
    (~m² multiply-adds, like the plain path's matvec with M⁻¹) instead of
    forming M⁻¹ in the kernel: the unrolled factor is a third of the
    inverse's ~m³/2 ops, which keeps the compile time of the m=15 kernel
    short. The ADMM iterations are one loop in the compiled kernel, not
    `iters` unrolled copies.
    """
    n = m // 3
    lanes = pl.ds(pl.program_id(0) * block, block)
    col = lambda ref, i: ref[lanes, i]
    g = [col(g_ref, i) for i in range(m)]
    x = [col(x_ref, i) for i in range(m)]
    c = [col(c_ref, k) for k in range(n)]
    dx = [col(dxy_ref, 2 * k) for k in range(n)]
    dy = [col(dxy_ref, 2 * k + 1) for k in range(n)]
    dlo = [col(lo_ref, i) - x[i] for i in range(m)]
    dhi = [col(hi_ref, i) - x[i] for i in range(m)]

    def E(i, j):
        e = col(B_ref, i * m + j)
        ki, a = divmod(i, 3)
        kj, b = divmod(j, 3)
        if ki == kj and a < 2 and b < 2:
            e = e + rho * ((dx if a == 0 else dy)[ki]
                           * (dx if b == 0 else dy)[kj])
        if i == j:
            e = e + (sigma + rho)
        return e

    L, D = _chol_factor_unrolled(E, m)

    def admm_iter(_, carry):
        d, zb, zc, wb, wc = carry
        zcw = [zc[k] - wc[k] for k in range(n)]
        rhs = []
        for i in range(m):
            k, a = divmod(i, 3)
            r = -g[i] + sigma * d[i] + rho * (zb[i] - wb[i])
            if a == 0:
                r = r + rho * (dx[k] * zcw[k])
            elif a == 1:
                r = r + rho * (dy[k] * zcw[k])
            rhs.append(r)
        d = _chol_solve_unrolled(L, D, rhs)
        zb = [jnp.clip(d[i] + wb[i], dlo[i], dhi[i]) for i in range(m)]
        Jd = [dx[k] * d[3 * k] + dy[k] * d[3 * k + 1] for k in range(n)]
        zc = [jnp.maximum(Jd[k] + wc[k], -c[k]) for k in range(n)]
        wb = [wb[i] + d[i] - zb[i] for i in range(m)]
        wc = [wc[k] + Jd[k] - zc[k] for k in range(n)]
        return d, zb, zc, wb, wc

    init = tuple([col(ref, i) for i in range(rows)]
                 for ref, rows in ((d_ref, m), (zb_ref, m), (zc_ref, n),
                                   (wb_ref, m), (wc_ref, n)))
    d, zb, zc, wb, wc = jax.lax.fori_loop(0, iters, admm_iter, init)

    for ref, vals in ((dout_ref, [jnp.clip(d[i], dlo[i], dhi[i])
                                  for i in range(m)]),
                      (dN_ref, d), (zbN_ref, zb), (zcN_ref, zc),
                      (wbN_ref, wb), (wcN_ref, wc)):
        for i, v in enumerate(vals):
            ref[lanes, i] = v


def _qp_admm_triton(Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0, wc0,
                    *, iters: int, rho: float, sigma: float,
                    block: int = _QP_BLOCK, interpret: bool = False):
    """Batched fused QP through Pallas-Triton: the (B, rows) operands of the
    vmapped plain path in, one kernel launch, its seven outputs out.

    A batch that is not a multiple of `block` is padded with zero lanes
    (their M is (σ+ρ)I, so they run the same finite arithmetic) that are
    sliced off again."""
    B = Bflat.shape[0]
    m = g.shape[-1]
    n = m // 3
    Bp = -(-B // block) * block
    pad = lambda a: a if Bp == B else jnp.pad(a, ((0, Bp - B), (0, 0)))
    out_rows = (m, m, m, n, m, n)
    outs = pl.pallas_call(
        functools.partial(_qp_admm_kernel, iters=iters, rho=rho, sigma=sigma,
                          m=m, block=block),
        out_shape=tuple(jax.ShapeDtypeStruct((Bp, r), jnp.float32)
                        for r in out_rows),
        grid=(Bp // block,),
        compiler_params=pltriton.CompilerParams(num_warps=max(1, block // 32)),
        backend="triton",
        interpret=interpret,
        name="qp_admm",
    )(*(pad(a) for a in (Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0,
                         wc0)))
    d_out, d, zb, zc, wb, wc = (o[:B] for o in outs)
    return d_out, rho * wc, d, zb, zc, wb, wc


def _by_platform(args, kernel, plain):
    """The compiled platform picks the batched QP's path: the kernel for a
    CUDA GPU, the plain XLA path everywhere else. Both are traced; XLA
    lowers only the branch of the platform it compiles for."""
    return jax.lax.platform_dependent(*args, cuda=kernel, default=plain)


@functools.lru_cache(maxsize=None)
def _qp_admm_core(iters: int, rho: float, sigma: float, m: int):
    """custom_vmap wrapper: the plain XLA path per lane; under vmap, the
    fused kernel where the platform has one (_by_platform). On the H100 the
    kernel beat the plain path at every batch measured, 64 to 4096 lanes
    (PERF.md), so no batch threshold guards it. lru_cached so every trace
    of the same static config reuses one custom_vmap object."""
    n = m // 3
    plain = functools.partial(_qp_admm_plain, iters=iters, rho=rho,
                              sigma=sigma)

    @jax.custom_batching.custom_vmap
    def core(Bflat, g, x, c, J, lo, hi, d0, zb0, zc0, wb0, wc0):
        return plain(Bflat, g, x, c, J, lo, hi, d0, zb0, zc0, wb0, wc0)

    @core.def_vmap
    def rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size,) + a.shape)
                for a, b in zip(args, in_batched)]
        out_batched = (True,) * 7
        plain_batched = jax.vmap(plain)
        if args[0].ndim != 2 or args[0].dtype != jnp.float32:
            return plain_batched(*args), out_batched

        def kernel(Bflat, g, x, c, J, *rest):
            # The cone Jacobian's only nonzeros are (row k, cols 3k/3k+1);
            # hand the kernel just those (dx_k, dy_k interleaved).
            dxy = jnp.stack(
                [J[:, k, 3 * k + a] for k in range(n) for a in (0, 1)],
                axis=-1)
            return _qp_admm_triton(Bflat, g, x, c, dxy, *rest, iters=iters,
                                   rho=rho, sigma=sigma)

        return _by_platform(args, kernel, plain_batched), out_batched

    return core


class _SqpState(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    grad: jnp.ndarray
    # BFGS curvature, carried FLAT (m²,) so the batched carry is one dense
    # (B, m²) buffer. Consumers reshape to (m, m) at the two places that
    # need the matrix form.
    B: jnp.ndarray
    mu: jnp.ndarray
    k: jnp.ndarray
    small_count: jnp.ndarray
    done: jnp.ndarray
    ls_failed: jnp.ndarray
    qp: tuple  # ADMM warm-start carry (d, zb, zc, wb, wc)
    # Last accepted line-search alpha (1.0 after a failure/reset); feeds the
    # warm initial candidate when cfg.solver_ls_warm_alpha is on.
    alpha0: jnp.ndarray


def _make_sqp(
    f: Callable[[jnp.ndarray], jnp.ndarray],
    cfg: MpcConfig,
    ftol: float | None = None,
    qp_iters: int | None = None,
    max_backtracks: int | None = None,
    parallel_ls: bool = False,
    ls_wave: int = 1,
    ls_backtrack: float | None = None,
    limits=None,
):
    """Build the SQP iteration machinery for one objective: returns
    (init, run, body) where init(x0) -> _SqpState evaluates the warm start,
    run(state, upto_k) continues outer iterations while ~done and k < upto_k,
    and body is one raw SQP iteration (for batch-level loop restructuring —
    the adaptive compaction in make_sqp_solver_batched).

    Splitting init/run (instead of one closed sqp_solve) is what lets the
    batched front-end re-batch lanes mid-solve: run(st, k1) on the full batch,
    gather the still-alive lanes, run(st_sub, max_iters) on the compact batch.
    Per-lane values are bit-identical however the iterations are grouped —
    the body touches only lane-local state.

    max_backtracks: under vmap every lane pays the slowest lane's backtrack
    count, and at fleet batch sizes some lane is always at the nonsmooth kink,
    so the line-search while runs the full budget every iteration. Steps below
    2^-15·d are under float32 resolution of the iterate — nothing is lost
    capping there, and each halving costs one full objective evaluation for
    the whole batch.
    """
    ftol = cfg.opt_tolerance if ftol is None else ftol
    qp_iters = cfg.qp_iters if qp_iters is None else qp_iters
    max_backtracks = (cfg.solver_max_backtracks if max_backtracks is None
                      else max_backtracks)
    bt = float(cfg.solver_ls_backtrack if ls_backtrack is None
               else ls_backtrack)
    coarse_after = int(cfg.solver_ls_coarse_after)
    coarse = float(cfg.solver_ls_coarse_factor)
    warm_ls = bool(cfg.solver_ls_warm_alpha)
    quad_ls = bool(cfg.solver_ls_quad_interp)
    if quad_ls and (parallel_ls or ls_wave > 1):
        # Only the sequential branch implements interpolation; the
        # candidate-grid branches (both measured losers, PERF.md) would
        # silently drop it — and with quad_ls now default-on in
        # fleet_config, a silent drop would erase the advertised
        # fidelity/throughput gains without a trace.
        raise ValueError(
            "solver_ls_quad_interp is only implemented for the sequential "
            "line search; disable it to use parallel_line_search/ls_wave")

    def _ls_alpha(j):
        """Candidate alpha after j rejections: bt^min(j,F) · coarse^max(j−F,0)
        (single-phase when coarse_after == 0)."""
        jf = j.astype(jnp.float32) if hasattr(j, "astype") else float(j)
        if coarse_after <= 0:
            return jnp.power(bt, jf)
        fine = jnp.minimum(jf, float(coarse_after))
        return jnp.power(bt, fine) * jnp.power(coarse, jf - fine)

    def _ls_factor(j):
        """Multiplicative factor applied after rejected trip j."""
        if coarse_after <= 0:
            return bt
        return jnp.where(j < coarse_after, bt, coarse)

    val_grad = jax.value_and_grad(f)

    n = cfg.control_steps
    m = 3 * n
    if limits is None:
        lo = jnp.tile(jnp.array([cfg.min_vel_x, cfg.min_vel_y, cfg.min_vel_theta], jnp.float32), n)
        hi = jnp.tile(jnp.array([cfg.max_vel_x, cfg.max_vel_y, cfg.max_vel_theta], jnp.float32), n)
        max_trans = None
    else:
        lo = jnp.tile(jnp.asarray(limits.vel_lo, jnp.float32), n)
        hi = jnp.tile(jnp.asarray(limits.vel_hi, jnp.float32), n)
        max_trans = jnp.asarray(limits.max_vel_trans, jnp.float32)

    # grad-only companion to val_grad: the SQP body re-derives f(x_new) from
    # the accepted line-search candidate (every candidate evaluation already
    # computes it), so the post-step call needs ONLY the gradient — and in
    # parity mode the costmap term is piecewise-constant in the controls
    # (nearest-cell gather behind floor+int cast: zero tangent path), so
    # partial-eval/DCE strips the whole per-lane costmap gather from the
    # grad-only computation. One of the two gathers per SQP iteration
    # disappears.
    grad_f = jax.grad(f)

    def merit(x, mu):
        """Returns (phi, f): the L1 merit and the raw objective at x."""
        c, _ = _cone_constraints(x, cfg, max_trans)
        fv = f(x)
        return fv + mu * jnp.sum(jnp.maximum(-c, 0.0)), fv

    def body(s: _SqpState) -> _SqpState:
        c, J = _cone_constraints(s.x, cfg, max_trans)
        d, y_cone, qp = _qp_admm(s.B, s.grad, s.x, c, J, cfg, qp_iters, lo,
                                 hi, init=s.qp)

        # Exact-penalty weight: dominate the largest multiplier estimate.
        mu = jnp.maximum(s.mu, 1.5 * jnp.max(jnp.abs(y_cone)) + 1e-3)
        phi0 = s.f + mu * jnp.sum(jnp.maximum(-c, 0.0))
        # Directional derivative bound for Armijo.
        dphi = _vdot(s.grad, d) - mu * jnp.sum(jnp.maximum(-c, 0.0))

        # Initial candidate: 1, or the per-lane warm start (config knob).
        if warm_ls:
            a_init = jnp.minimum(jnp.asarray(1.0, s.x.dtype), 2.0 * s.alpha0)
        else:
            a_init = jnp.asarray(1.0, s.x.dtype)

        if parallel_ls:
            # Parallel Armijo: under vmap the sequential backtracking loop
            # locksteps at the slowest lane (some lane is always at the
            # control-cost kink, so it runs the FULL budget every iteration —
            # confirmed by device traces). Evaluating every candidate 2^-j in
            # one fused wave selects exactly the same alpha as sequential
            # halving, replacing max_backtracks loop trips with one wide eval.
            alphas = a_init * _ls_alpha(
                jnp.arange(max_backtracks, dtype=s.x.dtype))
            cands = s.x[None, :] + alphas[:, None] * d[None, :]
            phis, fs = jax.vmap(lambda xx: merit(xx, mu))(cands)
            ok_mask = phis <= phi0 + 1e-4 * alphas * dphi + 1e-12
            ls_ok = jnp.any(ok_mask)
            sel = jnp.argmax(ok_mask)
            alpha = alphas[sel]
            f_ls = fs[sel]
        elif ls_wave > 1:
            # Wave Armijo: evaluate `ls_wave` consecutive halving candidates
            # per merit evaluation. When the merit cost is dominated by the
            # FIXED overhead of the batched costmap gather (whatever the
            # number of points it fetches), one
            # K-candidate wave costs barely more than one candidate while
            # covering K sequential trips; under lockstep vmap the while now
            # runs ceil(trips/K) iterations at the slowest lane. Selection is
            # the FIRST accepted candidate in halving order — bit-identical
            # alphas to sequential backtracking.
            K = ls_wave
            kf = jnp.arange(K, dtype=s.x.dtype)

            def lsw_cond(carry):
                alpha, j, ok, facc = carry
                return (~ok) & (j < max_backtracks)

            def lsw_body(carry):
                alpha, j, ok, facc = carry
                alphas = a_init * _ls_alpha(kf + j.astype(s.x.dtype))
                cands = s.x[None, :] + alphas[:, None] * d[None, :]
                phis, fs = jax.vmap(lambda xx: merit(xx, mu))(cands)
                okm = phis <= phi0 + 1e-4 * alphas * dphi + 1e-12
                # The last wave may overhang the budget when K does not
                # divide max_backtracks; candidates past it must not be
                # acceptable (the sequential branch never evaluates them).
                okm = okm & (kf + j.astype(s.x.dtype) < max_backtracks)
                any_ok = jnp.any(okm)
                hit = jnp.argmax(okm)
                sel = alphas[hit]
                alpha_next = jnp.where(ok, alpha, jnp.where(any_ok, sel, alpha))
                facc_next = jnp.where(ok, facc,
                                      jnp.where(any_ok, fs[hit], facc))
                return (alpha_next, j + K, ok | any_ok, facc_next)

            # Done lanes accept immediately (ok starts True) — same
            # short-circuit as the sequential branch below.
            alpha, _, ls_ok, f_ls = jax.lax.while_loop(
                lsw_cond, lsw_body, (a_init, jnp.int32(0), s.done, s.f))
        else:
            def ls_cond(carry):
                alpha, j, ok, facc = carry
                return (~ok) & (j < max_backtracks)

            def ls_body(carry):
                alpha, j, ok, facc = carry
                phi, fv = merit(s.x + alpha * d, mu)
                ok = phi <= phi0 + 1e-4 * alpha * dphi + 1e-12
                if quad_ls:
                    # Quadratic-interpolation backtracking (N&W §3.5): the
                    # minimizer of the quadratic through phi(0)=phi0,
                    # phi'(0)=dphi, phi(alpha)=phi. On a rejection
                    # phi > phi0 + c·alpha·dphi, so the denominator is
                    # positive and the minimizer sits in (0, alpha);
                    # safeguard to [0.1, 0.5]·alpha against tiny/degenerate
                    # curvature (dphi ~ 0 at the nonsmooth kink).
                    denom = 2.0 * (phi - phi0 - dphi * alpha)
                    a_q = -dphi * alpha * alpha / jnp.where(
                        jnp.abs(denom) > 1e-20, denom, 1e-20)
                    a_next = jnp.clip(a_q, 0.1 * alpha, 0.5 * alpha)
                else:
                    a_next = alpha * _ls_factor(j)
                alpha_next = jnp.where(ok, alpha, a_next)
                facc = jnp.where(ok, fv, facc)
                return (alpha_next, j + 1, ok, facc)

            # Converged lanes accept immediately (ok starts True): under vmap
            # the backtracking while runs until EVERY lane accepts, and a done
            # lane sitting at a nonsmooth stationary point otherwise burns the
            # full budget every remaining outer iteration, dragging the whole
            # batch through ~16 lockstep merit evaluations it will discard.
            # Its own updates are frozen below regardless.
            alpha, _, ls_ok, f_ls = jax.lax.while_loop(
                ls_cond, ls_body, (a_init, jnp.int32(0), s.done, s.f))

        step_vec = jnp.where(ls_ok, alpha * d, jnp.zeros_like(d))
        x_new = s.x + step_vec
        # f(x_new) was already computed by the accepted line-search candidate
        # (or is s.f unchanged on failure); only the gradient is fresh work —
        # and it needs no costmap gather (see grad_f above).
        f_new = jnp.where(ls_ok, f_ls, s.f)
        g_new = grad_f(x_new)

        # Damped BFGS (Powell) on the accepted step.
        sv = step_vec
        yv = g_new - s.grad
        Bs = _dot(s.B.reshape(m, m), sv)
        sBs = _vdot(sv, Bs)
        sy = _vdot(sv, yv)
        theta = jnp.where(
            sy < 0.2 * sBs,
            0.8 * sBs / jnp.maximum(sBs - sy, 1e-16),
            1.0,
        )
        yv = theta * yv + (1.0 - theta) * Bs
        sy = _vdot(sv, yv)
        update_ok = ls_ok & (sBs > 1e-16) & (sy > 1e-16)
        B_new = jnp.where(
            update_ok,
            s.B - (jnp.outer(Bs, Bs) / jnp.maximum(sBs, 1e-16)
                   - jnp.outer(yv, yv) / jnp.maximum(sy, 1e-16)).reshape(-1),
            s.B,
        )

        # Require two consecutive sub-ftol improvements before declaring
        # convergence — a single tiny step can just be a flat stretch before
        # the valley curves (observed on adversarial random scenarios). A
        # sub-ftol improvement with a vanishing FULL QP direction is genuine
        # stationarity though (the model itself proposes no movement), so it
        # counts double: warm-started lanes at the optimum exit after one
        # iteration instead of two, which at fleet batch sizes halves the
        # lockstep depth of steady-state solves.
        improved = jnp.abs(s.f - f_new)
        small = ls_ok & (improved < ftol)
        stationary = small & (jnp.max(jnp.abs(d)) < 1e-6)
        small_count = jnp.where(small, s.small_count + 1 + stationary, 0)
        # First line-search failure: reset the BFGS model (a stale/ill-scaled B
        # is the usual culprit) and try once more; second failure terminates —
        # at the nonsmooth kink this is the stationary stop, like SLSQP.
        B_new = jnp.where(ls_ok, B_new,
                          jnp.eye(m, dtype=x_new.dtype).reshape(-1))
        # (Converged lanes need no explicit freeze here: vmap's while_loop
        # batching rule masks the carry update with the per-lane cond, so a
        # done lane's state never changes — only its share of in-body compute
        # is wasted, which the line-search short-circuit above bounds.)
        done = (small_count >= 2) | (s.ls_failed & ~ls_ok)
        alpha0 = (jnp.where(ls_ok, alpha, jnp.asarray(1.0, x_new.dtype))
                  if warm_ls else s.alpha0)
        return _SqpState(x=x_new, f=f_new, grad=g_new, B=B_new, mu=mu,
                         k=s.k + 1, small_count=small_count, done=done,
                         ls_failed=~ls_ok, qp=qp, alpha0=alpha0)

    def init(x0: jnp.ndarray) -> _SqpState:
        # Start from the box-clipped warm start (scipy clips x0 into bounds).
        x0 = jnp.clip(jnp.asarray(x0, jnp.float32), lo, hi)
        f0, g0 = val_grad(x0)
        zeros_m = jnp.zeros_like(x0)
        zeros_n = jnp.zeros(n, x0.dtype)
        return _SqpState(
            x=x0, f=f0, grad=g0, B=jnp.eye(m, dtype=x0.dtype).reshape(-1),
            mu=jnp.asarray(1.0, x0.dtype), k=jnp.int32(0),
            small_count=jnp.int32(0),
            done=jnp.asarray(False), ls_failed=jnp.asarray(False),
            qp=(zeros_m, zeros_m, zeros_n, zeros_m, zeros_n),
            alpha0=jnp.asarray(1.0, x0.dtype),
        )

    def run(s: _SqpState, upto_k: int) -> _SqpState:
        return jax.lax.while_loop(
            lambda s: (~s.done) & (s.k < upto_k), body, s)

    return init, run, body


def sqp_solve(
    f: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    cfg: MpcConfig,
    ftol: float | None = None,
    max_iters: int | None = None,
    qp_iters: int | None = None,
    max_backtracks: int | None = None,
    parallel_ls: bool = False,
    limits=None,
) -> SolveResult:
    """Minimize f over box ∩ cone from warm start x0 (SLSQP-equivalent)."""
    max_iters = cfg.solver_max_iters if max_iters is None else max_iters
    init, run, _ = _make_sqp(f, cfg, ftol=ftol, qp_iters=qp_iters,
                             max_backtracks=max_backtracks,
                             parallel_ls=parallel_ls,
                             ls_wave=cfg.solver_ls_wave, limits=limits)
    fin = run(init(x0), max_iters)
    # SLSQP reports success both at ftol convergence and when the line search
    # collapses at a (possibly nonsmooth) stationary point.
    return SolveResult(x=fin.x, fun=fin.f, converged=fin.done, iters=fin.k)


def _lane_hoist(cfg: MpcConfig, objective, scen):
    """Per-solve constant ARRAYS the objective hoists out of the solver
    loops. Split from _lane_fobj so callers that emit the SQP body inside
    their own loop (the adaptive batch-level while) can compute these once
    outside it — tracing a hoist inside a while body re-emits its ops every
    trip (the parity footprint term is a full polygon cost evaluation)."""
    if getattr(objective, "parity", True):
        from .ops.objective import parity_footprint_term

        return parity_footprint_term(scen, cfg)
    return jnp.zeros(())


def _lane_fobj(cfg: MpcConfig, objective, scen, fp_term=None):
    """Per-scenario objective closure with the per-solve hoists applied.
    fp_term: pre-hoisted _lane_hoist result (computed here when omitted)."""
    if getattr(objective, "parity", True):
        from .ops.costmap import make_point_sampler

        if fp_term is None:
            fp_term = _lane_hoist(cfg, objective, scen)
        # Per-solve sampler: hoists the costmap relayout (and, with
        # solver_costmap_patch > 0, the whole map read) out of the
        # solver's while loops. Values are bit-identical to
        # cost_at_world (see ops.costmap.make_point_sampler).
        sampler = make_point_sampler(
            scen.costmap, scen.current_pose[0], scen.current_pose[1],
            cfg.solver_costmap_patch)
        return lambda u: objective(u, scen, fp_term, point_sampler=sampler)
    if cfg.solver_costmap_patch > 0 and scen.costmap.win_cells is None:
        # Product objective: hoist ONE patch extraction per solve; every
        # bilinear point cost and footprint boundary sample in the solver's
        # loops then contracts over the (P, P) patch instead of the full
        # map (map-size-independent; see ProductPatchSampler). The caller
        # sizes the halfwidth via required_product_patch_halfwidth (rollout
        # reach + footprint circumradius + the bilinear neighbor).
        from .ops.costmap import ProductPatchSampler

        sampler = ProductPatchSampler(
            scen.costmap, scen.current_pose[0], scen.current_pose[1],
            cfg.solver_costmap_patch, exact=cfg.solver_patch_exact_picks)
        return lambda u: objective(u, scen, point_sampler=sampler)
    return lambda u: objective(u, scen)


def make_sqp_solver(cfg: MpcConfig, objective, ftol: float | None = None,
                    max_iters: int | None = None, qp_iters: int | None = None,
                    parallel_ls: bool | None = None):
    """objective: callable from ops.objective.make_objective (full objective,
    control term included — the SQP treats it smoothly, like SLSQP's finite
    differences do a.e.). Returns solve(x0, scenario) -> SolveResult."""

    def solve(x0, scen):
        fobj = _lane_fobj(cfg, objective, scen)
        return sqp_solve(fobj, x0, cfg, ftol=ftol, max_iters=max_iters,
                         qp_iters=qp_iters,
                         parallel_ls=(cfg.parallel_line_search
                                      if parallel_ls is None else parallel_ls),
                         limits=scen.limits)

    return solve


def make_sqp_solver_batched(cfg: MpcConfig, objective,
                            ftol: float | None = None,
                            max_iters: int | None = None,
                            qp_iters: int | None = None,
                            parallel_ls: bool | None = None):
    """Batched SQP solve with lockstep-tail compaction.

    Under plain vmap the outer while runs until the SLOWEST lane converges —
    every iteration past the typical warm depth pays full-batch Cholesky +
    val_grad + ADMM for a handful of straggler lanes (warm solves are
    mostly done by ~4 iterations while stragglers run to the cap). This
    front-end runs `cfg.solver_compact_after` full-batch iterations, then —
    when at most ceil(B · solver_compact_frac) lanes are still alive —
    gathers those lanes (solver state + scenario) into a compact sub-batch,
    finishes only them, and scatters the results back. If more lanes are alive
    (e.g. a cold start), it falls back to continuing the full batch.

    Per-lane math is identical in every grouping (the SQP body touches only
    lane-local state; batched while_loop masking freezes done lanes). Both
    branches compile graphs whose float ops XLA may fuse/reassociate
    differently from vmap(sqp_solve) — solutions agree to ~1e-6 (inside
    every parity/golden gate; same policy as the tree-summed Cholesky,
    PERF.md). Since the objective value is re-derived from the accepted
    line-search candidate (the grad-only post-step), an `improved < ftol`
    tie within ~1 ulp can also shift a lane's termination by one iteration
    between groupings (tests/test_compact.py compares commands bitwise and
    `fun` to float noise).

    Returns solve_batch(x0s, scens) -> batched SolveResult.
    """
    max_iters_ = cfg.solver_max_iters if max_iters is None else max_iters
    pls = cfg.parallel_line_search if parallel_ls is None else parallel_ls

    def lane(scen, fp_term=None):
        fobj = _lane_fobj(cfg, objective, scen, fp_term=fp_term)
        return _make_sqp(fobj, cfg, ftol=ftol, qp_iters=qp_iters,
                         parallel_ls=pls, ls_wave=cfg.solver_ls_wave,
                         limits=scen.limits)

    def solve_batch(x0s, scens):
        batch = x0s.shape[0]
        k1 = cfg.solver_compact_after
        frac = cfg.solver_compact_frac
        compact_n = int(np.ceil(batch * frac)) if frac > 0 else batch
        eligible = (0 < compact_n < batch
                    and batch >= cfg.solver_compact_min_batch)
        use = eligible and 0 < k1 < max_iters_

        # Patch-hoisted sampling (solver_costmap_patch > 0) is incompatible
        # with the adaptive restructuring: vbody re-enters _lane_fobj inside
        # the batch-level while body, so the per-solve patch EXTRACTION
        # (full-map pad + per-lane slice / one-hot window read) would be
        # re-traced and re-executed every trip — the same re-emitted-hoist
        # pathology the fpts hoist below fixes for the footprint term. The
        # plain path keeps the hoist (its lane closures are built outside
        # the solver's while loops), so fall through to it rather than
        # paying the pathology.
        if (cfg.solver_compact_adaptive and eligible and max_iters_ > 1
                and cfg.solver_costmap_patch == 0):
            # Adaptive compaction (difficulty-aware lockstep): instead of a
            # fixed k1 full-batch iterations, run full-batch SQP iterations
            # only WHILE more than compact_n lanes are still alive, then
            # gather the stragglers and finish them compactly. A warm tick
            # whose alive count collapses after 3 iterations stops paying
            # full-batch trips at iteration 4, not k1 — the easy lanes stop
            # setting (and funding) the hard lanes' lockstep depth at the
            # earliest point the tail fits the compact sub-batch. Per-lane
            # math is identical to the plain path: the masked full-batch
            # step below IS what vmap's while_loop batching rule does.
            # Per-solve hoists (footprint term) computed ONCE, outside the
            # batch-level while — ops traced inside its body are re-emitted
            # every trip.
            fpts = jax.vmap(lambda sc: _lane_hoist(cfg, objective, sc))(scens)
            st0 = jax.vmap(lambda x0, sc, ft: lane(sc, ft)[0](x0))(
                x0s, scens, fpts)
            vbody = jax.vmap(lambda s, sc, ft: lane(sc, ft)[2](s))

            def alive_of(st):
                return (~st.done) & (st.k < max_iters_)

            def bstep(st):
                a = alive_of(st)
                new = vbody(st, scens, fpts)
                return jax.tree.map(
                    lambda o, nw: jnp.where(
                        a.reshape((batch,) + (1,) * (o.ndim - 1)), nw, o),
                    st, new)

            st = jax.lax.while_loop(
                lambda st: jnp.sum(alive_of(st)) > compact_n, bstep, st0)
            alive = alive_of(st)
            idx = jnp.nonzero(alive, size=compact_n, fill_value=0)[0]
            sub_st = jax.tree.map(lambda a_: a_[idx], st)
            sub_sc = jax.tree.map(lambda a_: a_[idx], scens)
            fin = jax.vmap(lambda s, sc, ft: lane(sc, ft)[1](s, max_iters_))(
                sub_st, sub_sc, fpts[idx])
            st = jax.tree.map(lambda full, sub: full.at[idx].set(sub),
                              st, fin)
            return SolveResult(x=st.x, fun=st.f, converged=st.done, iters=st.k)

        st = jax.vmap(lambda x0, sc: lane(sc)[1](lane(sc)[0](x0),
                                                 k1 if use else max_iters_)
                      )(x0s, scens)
        if use:
            run_to_end = jax.vmap(lambda s, sc: lane(sc)[1](s, max_iters_))
            alive = (~st.done) & (st.k < max_iters_)

            def compact(_):
                idx = jnp.nonzero(alive, size=compact_n, fill_value=0)[0]
                sub_st = jax.tree.map(lambda a: a[idx], st)
                sub_sc = jax.tree.map(lambda a: a[idx], scens)
                fin = run_to_end(sub_st, sub_sc)
                # Duplicate fill indices (lane 0) all scatter the same value:
                # a done lane's continuation is the identity.
                return jax.tree.map(lambda full, sub: full.at[idx].set(sub),
                                    st, fin)

            def full(_):
                return run_to_end(st, scens)

            st = jax.lax.cond(jnp.sum(alive) <= compact_n, compact, full, None)
        return SolveResult(x=st.x, fun=st.f, converged=st.done, iters=st.k)

    return solve_batch
