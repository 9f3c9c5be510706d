"""Solver setup: builds the per-level operator context from a config.

This is the matrix-free analogue of the reference's setup + assembly phase
(reference: src/poisson.c:85-118 SetUpMesh/SetUpIndices/SetUpOperator/
SetUpSolver/Assemble): instead of assembling distributed CSR matrices it
evaluates stencil-coefficient arrays per grid and wires matrix-free applies,
smoothers and transfers for every level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp

from multigrid_petsc_tpu.hierarchy import LevelSpec, build_hierarchy
from multigrid_petsc_tpu.mesh import MeshType
from multigrid_petsc_tpu.problems import (
    Problem,
    poisson_sin_problem,
    rhs_grid,
    stencil_coefficients,
)
from multigrid_petsc_tpu.ops.stencil import Stencil5
from multigrid_petsc_tpu.ops.composite import composite_apply, composite_rhs
from multigrid_petsc_tpu.ops.transfer import prolong_multi, restrict_multi
from multigrid_petsc_tpu.solvers import smoothers as sm
from multigrid_petsc_tpu.utils.config import (
    CycleType,
    SmootherType,
    SolverConfig,
)

State = tuple  # tuple of per-grid 2-D arrays


@dataclass
class LevelCtx:
    """Static per-level context: spec + operator/smoother closures.

    The closures close over this level's stencil-coefficient arrays.  For
    the tensor-product problems these are (ny, 1) arrays — negligible jit
    constants; fully-variable coefficient problems should pass coefficient
    fields as explicit jit arguments (see ops/stencil.py notes).
    """

    spec: LevelSpec
    stencils: tuple[Stencil5, ...]
    dinv: State
    smooth: Callable[[State, State, int], State] = None  # (b, u, sweeps)
    lmax: float | None = None  # Chebyshev bound on spec(D^-1 A), if used
    shardings: tuple | None = None  # per-grid NamedSharding (distributed mode)
    coarse_solve: Callable | None = None  # real coarsest-level solver
    # Explicit sparse backend (cfg.backend == "sparse"): the level operator
    # as an assembled matrix (ops/sparse.SparseLevelOp) — the reference's
    # always-explicit form (src/solver.c:489-556 levelMatrixA/A1/A2).
    sparse_full: object | None = None
    sparse_diag: object | None = None   # A1: grid-diagonal blocks only
    sparse_coup: object | None = None   # A2: coupling blocks only
    # The level's smoother steps run the CUDA kernel
    # (ops/smooth5_cuda.smooth5) instead of the jnp sweeps.
    cuda_smoother: bool = False
    # V-cycle level visits (see vcycle.v_cycle):
    #   visit_down(b, u, sweeps) -> (u', restrict_fw(b - A u'))
    #   visit_up(b, u, e_coarse, sweeps, emit_r) ->
    #       u'' = smooth(b, u + P e_coarse)  [, b - A u'']
    visit_down: Callable = None
    visit_up: Callable = None

    @property
    def shapes(self) -> list[tuple[int, int]]:
        """Per-grid state-array shapes."""
        return [g.shape for g in self.spec.grids]

    def apply(self, u: State) -> State:
        from multigrid_petsc_tpu.ops.stencil import Stencil9, apply_stencil9

        if self.sparse_full is not None:
            return self.sparse_full.apply(u)
        if isinstance(self.stencils[0], Stencil9):
            # 9-point path (anisotropic family): single grid per level.
            return (apply_stencil9(self.stencils[0], u[0]),)
        return composite_apply(self.stencils, self.spec.gids, u)

    def apply_diag(self, u: State) -> State:
        if self.sparse_diag is not None:
            return self.sparse_diag.apply(u)
        if self.sparse_full is not None and not self.spec.is_composite:
            return self.sparse_full.apply(u)  # 1 grid: A1 == A
        return composite_apply(
            self.stencils, self.spec.gids, u, include_couplings=False
        )

    def apply_couplings(self, u: State) -> State:
        if self.sparse_coup is not None:
            return self.sparse_coup.apply(u)
        return composite_apply(
            self.stencils, self.spec.gids, u, include_diag=False
        )

    def residual(self, b: State, u: State) -> State:
        au = self.apply(u)
        return tuple(bk - ak for bk, ak in zip(b, au))

    def zeros(self, dtype) -> State:
        z = tuple(jnp.zeros(s, dtype) for s in self.shapes)
        return self.constrain(z)

    def constrain(self, state: State) -> State:
        """Pin the state to this level's shardings (no-op single device).
        This is where the reference's level-dependent layout decisions
        (coarse-level agglomeration) get enforced on-device."""
        if self.shardings is None:
            return state
        return tuple(
            jax.lax.with_sharding_constraint(x, s)
            for x, s in zip(state, self.shardings)
        )


@dataclass
class MGContext:
    """Full solver context: all levels + inter-level transfers + RHS."""

    config: SolverConfig
    problem: Problem
    levels: list[LevelCtx]
    b0: State  # level-0 right-hand side
    dtype: object = jnp.float64
    # Reduced-precision preconditioner context (cfg.precond_dtype): a full
    # second level hierarchy in e.g. bfloat16 that the Krylov outers run
    # their V-cycle preconditioner through — half the device-memory bytes
    # per preconditioner application; outer accuracy is unaffected.
    precond_ctx: "MGContext | None" = None

    @property
    def path(self) -> str:
        """Which operator path the solve runs: "sparse" (assembled
        matrices), "cuda" (the CUDA smoother on level 0) or "generic" (the
        plain jnp operators).  The always-on KSPView analogue — the
        reference tells its user exactly what ran (src/solver.c:1560-1564);
        bench.py asserts it, so a silent routing change is visible."""
        lvl0 = self.levels[0]
        if lvl0.sparse_full is not None:
            return "sparse"
        return "cuda" if lvl0.cuda_smoother else "generic"

    # -- inter-level transfers (reference: src/solver.c:1035-1154 Res/Pro) --

    def restrict_to_next(self, l: int, r_primary: jnp.ndarray) -> State:
        """Restrict level l's primary-grid residual to ALL grids of level
        l+1 (composed multi-gap restriction for merged coarse grids).
        In distributed mode the result is pinned to the next level's
        shardings — the level-layout change (possibly an agglomerating
        all-gather) rides this transfer."""
        g0 = self.levels[l].spec.primary.g
        nxtc = self.levels[l + 1]
        out = [restrict_multi(r_primary, g.g - g0) for g in nxtc.spec.grids]
        return nxtc.constrain(tuple(out))

    def prolong_from_next(self, l: int, u_next: State) -> jnp.ndarray:
        """Prolong ALL grids of level l+1 onto level l's primary grid and
        sum (reference: Pro builds one matrix doing exactly this sum)."""
        out = self.prolong_half(l, u_next, gap_offset=0)
        if self.levels[l].shardings is not None:
            out = jax.lax.with_sharding_constraint(
                out, self.levels[l].shardings[0]
            )
        return out

    # -- split transfers for the level visits (vcycle.v_cycle) --
    # The down visit emits the residual already restricted by one gap and
    # the up visit applies the last prolongation gap itself; these helpers
    # do the REMAINING gaps.
    def restrict_rc1(self, l: int, rc1: jnp.ndarray) -> State:
        """Finish restriction given rc1 = restrict_fw(r) already at one
        gap below level l's primary grid."""
        g0 = self.levels[l].spec.primary.g
        nxtc = self.levels[l + 1]
        out = [restrict_multi(rc1, g.g - g0 - 1) for g in nxtc.spec.grids]
        return nxtc.constrain(tuple(out))

    def prolong_half(self, l: int, u_next: State,
                     gap_offset: int = 1) -> jnp.ndarray:
        """Prolong level l+1's grids to ONE gap below level l's primary
        grid and sum (the final gap is applied by visit_up; identical to
        prolong_from_next by linearity of the bilinear stencil).
        ``gap_offset=0`` prolongs all the way to level l."""
        g0 = self.levels[l].spec.primary.g
        nxtc = self.levels[l + 1]
        out = None
        for g, ug in zip(nxtc.spec.grids, u_next):
            e = prolong_multi(ug, g.g - g0 - gap_offset)
            out = e if out is None else out + e
        return out


def _platform() -> str:
    return jax.devices()[0].platform


def _step_coeffs(kind: SmootherType, sweeps: int, omega: float,
                 lmax: float | None) -> tuple:
    """(alpha, beta) schedule of a Jacobi/Chebyshev level smoother."""
    if kind == SmootherType.JACOBI:
        return sm.jacobi_step_coeffs(sweeps, omega)
    return sm.chebyshev_step_coeffs(sweeps, lmax)


def _use_cuda_smoother(lc: LevelCtx, cfg: SolverConfig) -> bool:
    """backend='auto' runs a level's Jacobi/Chebyshev sweeps through the
    CUDA kernel where ops/smooth5_cuda.kernel_eligible says so (a GPU, one
    device, f32, 5-point, large level); backend='xla' never does."""
    from multigrid_petsc_tpu.ops import smooth5_cuda

    if cfg.backend != "auto" or lc.spec.is_composite:
        return False
    if cfg.smoother not in (SmootherType.JACOBI, SmootherType.CHEBYSHEV):
        return False
    n_dev = (1 if lc.shardings is None
             else int(lc.shardings[0].mesh.devices.size))
    return smooth5_cuda.kernel_eligible(
        lc.stencils[0], lc.spec.primary.shape, lc.dinv[0].dtype,
        cfg.max_sweeps, _platform(), n_dev)


def _build_smoother(ctx: LevelCtx, cfg: SolverConfig):
    kind = cfg.smoother
    if ctx.spec.is_composite and cfg.composite_smoother == "block_gs":
        # Composite levels default to grid-ordered block Gauss-Seidel: the
        # coupling blocks break diagonal dominance, so point smoothers on
        # the full composite matrix diverge (the reference leans on PETSc's
        # default ILU there; see smoothers.composite_block_gs).
        def smooth(b, u, sweeps, _ctx=ctx):
            return sm.composite_block_gs(
                _ctx.stencils, _ctx.spec.gids, _ctx.dinv, b, u, sweeps,
                inner=cfg.v[0], omega=cfg.omega,
            )
    elif kind in (SmootherType.JACOBI, SmootherType.CHEBYSHEV):
        if kind == SmootherType.CHEBYSHEV:
            ctx.lmax = float(
                sm.estimate_dinv_a_lmax(
                    ctx.apply, ctx.dinv, ctx.shapes, dtype=ctx.dinv[0].dtype
                )
            )
        if ctx.cuda_smoother:
            from multigrid_petsc_tpu.ops.smooth5_cuda import smooth5

            def smooth(b, u, sweeps, _ctx=ctx):
                steps = _step_coeffs(kind, sweeps, cfg.omega, _ctx.lmax)
                return (smooth5(_ctx.stencils[0], b[0], u[0], steps),)
        elif kind == SmootherType.JACOBI:
            def smooth(b, u, sweeps, _ctx=ctx):
                return sm.jacobi(
                    _ctx.apply, _ctx.dinv, b, u, sweeps, cfg.omega
                )
        else:
            def smooth(b, u, sweeps, _ctx=ctx):
                return sm.chebyshev(_ctx.apply, _ctx.dinv, b, u, sweeps,
                                    _ctx.lmax)
    elif kind == SmootherType.RBGS:
        from multigrid_petsc_tpu.ops.stencil import (
            Stencil9,
            sor_redblack_sweeps,
        )

        assert not ctx.spec.is_composite, "RBGS: 1 grid per level"
        assert not isinstance(ctx.stencils[0], Stencil9), (
            "RBGS is 5-point only (corner couplings break the two-color "
            "independence); use line smoothers for 9-point operators"
        )

        def smooth(b, u, sweeps, _ctx=ctx):
            return (
                sor_redblack_sweeps(
                    _ctx.stencils[0], b[0], u[0], sweeps, cfg.omega
                ),
            )
    elif kind in (SmootherType.LINE_Y, SmootherType.LINE_X, SmootherType.LINE_XY):
        from multigrid_petsc_tpu.ops.stencil import (
            Stencil9,
            line_jacobi_sweeps_x,
            line_jacobi_sweeps_y,
        )

        st = ctx.stencils[0]
        if not isinstance(st, Stencil9):
            # Promote a 5-point stencil to 9-point with zero corners so the
            # line smoother also serves the stretched-mesh 5-pt operators.
            z = jnp.zeros((1, 1), ctx.dinv[0].dtype)
            st = Stencil9(csw=z, cs=st.cs, cse=z, cw=st.cw, cc=st.cc,
                          ce=st.ce, cnw=z, cn=st.cn, cne=z)
        assert not ctx.spec.is_composite, "line smoother: 1 grid per level"

        def smooth(b, u, sweeps, _st=st, _kind=kind):
            ub = u[0]
            if _kind == SmootherType.LINE_Y:
                ub = line_jacobi_sweeps_y(_st, b[0], ub, sweeps, cfg.omega)
            elif _kind == SmootherType.LINE_X:
                ub = line_jacobi_sweeps_x(_st, b[0], ub, sweeps, cfg.omega)
            else:  # alternating
                for _ in range(sweeps):
                    ub = line_jacobi_sweeps_y(_st, b[0], ub, 1, cfg.omega)
                    ub = line_jacobi_sweeps_x(_st, b[0], ub, 1, cfg.omega)
            return (ub,)
    else:
        raise ValueError(f"unknown smoother {kind}")
    return smooth


def _build_visits(lc: LevelCtx, cfg: SolverConfig):
    """V-cycle level-visit closures (see LevelCtx docstring).

    On a CUDA-smoother level the down visit's sweeps and residual are one
    kernel (zero initial guess: u is never read), and the up visit's
    sweeps plus its optional residual are another; elsewhere the visits
    compose the level's smoother and residual (same numerics up to
    summation order)."""
    from multigrid_petsc_tpu.ops.transfer import prolong_bilinear, restrict_fw

    kernel = None
    if lc.cuda_smoother:
        from multigrid_petsc_tpu.ops.smooth5_cuda import smooth5

        def kernel(b, u, sweeps, emit_r, _lc=lc):
            steps = _step_coeffs(cfg.smoother, sweeps, cfg.omega, _lc.lmax)
            return smooth5(_lc.stencils[0], b[0], u, steps, emit_r=emit_r)

    def visit_down(b, u, sweeps, _lc=lc):
        if kernel is not None:
            u0, r0 = kernel(b, None if u is None else u[0], sweeps, True)
            return (u0,), restrict_fw(r0)
        if u is None:
            u = _lc.zeros(b[0].dtype)
        u = _lc.smooth(b, u, sweeps)
        r = _lc.residual(b, u)
        return u, restrict_fw(r[0])

    def visit_up(b, u, e_c, sweeps, emit_r=False, _lc=lc):
        u0 = u[0] + prolong_bilinear(e_c)
        if _lc.shardings is not None:
            u0 = jax.lax.with_sharding_constraint(u0, _lc.shardings[0])
        if kernel is not None:
            out = kernel(b, u0, sweeps, emit_r)
            return ((out[0],), (out[1],)) if emit_r else (out,)
        u = _lc.smooth(b, (u0,) + u[1:], sweeps)
        if emit_r:
            return u, _lc.residual(b, u)
        return u

    return visit_down, visit_up


def build_context(
    cfg: SolverConfig,
    problem: Problem | None = None,
    plan=None,  # parallel.ShardingPlan for distributed mode
) -> MGContext:
    problem = problem or poisson_sin_problem()
    if (
        cfg.dtype == "float64"
        or cfg.outer_dtype in ("float64", "float32x2")
        # float32x2 needs x64 only at setup (f64 RHS/coefficients are
        # split exactly into two-float32 parts); the solve loop is pure f32.
    ) and not jax.config.jax_enable_x64:
        # Without x64, jnp silently truncates to f32 and a 1e-7 relative
        # residual target can spin to max_iter at the f32 roundoff floor.
        raise ValueError(
            "64-bit dtype/outer_dtype needs JAX's x64 mode: call "
            "jax.config.update('jax_enable_x64', True) at start-up")
    dtype = jnp.dtype(cfg.dtype)
    specs = build_hierarchy(cfg.npts, cfg.grids, cfg.levels)
    mesh_type = MeshType(cfg.mesh)

    use_sparse = cfg.backend == "sparse"
    if use_sparse:
        # Explicit backend limits: the native assembly engine
        # (native/csr_assemble.cpp) evaluates the Poisson mesh-metric
        # stencils; distribution of explicit matrices is not wired (the
        # matrix-free path is the production distributed path).
        if cfg.problem != "poisson":
            raise ValueError("backend='sparse': poisson problem family only")
        if plan is not None:
            raise ValueError(
                "backend='sparse' is the single-device explicit-operator "
                "path; use backend='auto'/'xla' for distributed runs"
            )

    aniso = cfg.problem == "aniso"
    if aniso:
        from multigrid_petsc_tpu.problems import (
            AnisoProblem,
            stencil9_coefficients,
        )

        if cfg.grids != cfg.levels:
            raise ValueError("aniso (9-pt) problem: composite levels "
                             "unsupported; use grids == levels")
        aniso_prob = AnisoProblem(*cfg.aniso)

    levels: list[LevelCtx] = []
    for spec in specs:
        if aniso:
            stencils = tuple(
                stencil9_coefficients(aniso_prob, g.ny, g.nx, dtype)
                for g in spec.grids
            )
        else:
            stencils = tuple(
                stencil_coefficients(mesh_type, g.ny, g.nx, dtype)
                for g in spec.grids
            )
        shardings = None
        if plan is not None:
            from multigrid_petsc_tpu.parallel.device_mesh import put_sharded

            shardings = tuple(plan.sharding(g.ny, g.nx) for g in spec.grids)
            # Coefficient columns follow the grid's y partition.
            stencils = tuple(
                type(st)(*(put_sharded(c, plan.coeff_sharding(g.ny, g.nx))
                           for c in st))
                for st, g in zip(stencils, spec.grids)
            )
        dinv = tuple(1.0 / st.cc for st in stencils)
        lc = LevelCtx(spec=spec, stencils=stencils, dinv=dinv,
                      shardings=shardings)
        if use_sparse:
            from multigrid_petsc_tpu.ops.sparse import SparseLevelOp

            gids = tuple(g.g for g in spec.grids)
            lc.sparse_full = SparseLevelOp(cfg.npts, cfg.mesh, gids,
                                           dtype=dtype)
            if spec.is_composite:
                # A1/A2 split for the E-cycle (reference: levelMatrixA1/A2,
                # src/solver.c:512-556).
                lc.sparse_diag = SparseLevelOp(
                    cfg.npts, cfg.mesh, gids, dtype=dtype,
                    include_couplings=False,
                )
                lc.sparse_coup = SparseLevelOp(
                    cfg.npts, cfg.mesh, gids, dtype=dtype,
                    include_diag=False,
                )
        levels.append(lc)

    # Per-level effective smoother (reference's fine_/levels_/coarse_
    # prefix capability, src/solver.c:1624-1648): each level's smoother,
    # visits and kernel choice resolve against its own tier.
    import dataclasses as _dc

    def _level_cfg(l: int) -> SolverConfig:
        eff = cfg.smoother_at(l, len(levels))
        return cfg if eff == cfg.smoother else _dc.replace(cfg, smoother=eff)

    for l, lc in enumerate(levels):
        lcfg = _level_cfg(l)
        lc.cuda_smoother = _use_cuda_smoother(lc, lcfg)
        lc.smooth = _build_smoother(lc, lcfg)
        lc.visit_down, lc.visit_up = _build_visits(lc, lcfg)

    # Real coarsest-level solver (see solvers/coarse.py): only when the
    # hierarchy actually has a coarse level (levels >= 2); the one-level
    # merged cycles (I/E/D*) must keep their own iteration semantics.
    if len(levels) >= 2 and cfg.coarse_solver != "smooth":
        from multigrid_petsc_tpu.solvers import coarse as coarse_mod

        last = levels[-1]
        shapes = last.shapes
        n_unknowns = sum(ny * nx for ny, nx in shapes)
        mode = cfg.coarse_solver
        if mode == "auto":
            mode = "direct" if n_unknowns <= cfg.max_direct_size else "cg"
        if mode == "direct":
            use_analytic = not last.spec.is_composite
            dense = None
            if last.spec.is_composite and cfg.problem == "poisson":
                # Composite coarsest: assemble the dense operator (incl.
                # R A_h / A_h P couplings) from the native CSR engine
                # instead of O(N) probing matvecs.
                from multigrid_petsc_tpu.ops.sparse import assemble_level_csr

                dense = coarse_mod.dense_from_csr(
                    *assemble_level_csr(
                        cfg.npts, cfg.mesh, tuple(g.g for g in last.spec.grids)
                    )
                )
            last.coarse_solve = coarse_mod.build_direct_solver(
                last.apply, shapes, dtype,
                stencils=last.stencils if use_analytic else None,
                dense=dense,
            )
        elif mode == "cg":
            last.coarse_solve = coarse_mod.build_cg_solver(
                last.apply, shapes, cfg.coarse_cg_iters
            )
        else:
            raise ValueError(f"unknown coarse_solver {cfg.coarse_solver}")

    # Level-0 RHS: f on grid 0, restricted f on merged coarser grids
    # (reference: src/solver.c:558-620 levelvecb fills only level 0).
    spec0 = specs[0]
    if aniso:
        from multigrid_petsc_tpu.problems import aniso_rhs_grid

        f0 = aniso_rhs_grid(aniso_prob, spec0.primary.ny, spec0.primary.nx, dtype)
        problem = aniso_prob
    else:
        f0 = rhs_grid(problem, mesh_type, spec0.primary.ny, spec0.primary.nx, dtype)
    b0 = composite_rhs(f0, spec0.gids)
    if plan is not None:
        from multigrid_petsc_tpu.parallel.device_mesh import put_sharded

        b0 = tuple(
            put_sharded(bb, s) for bb, s in zip(b0, levels[0].shardings)
        )

    out = MGContext(
        config=cfg, problem=problem, levels=levels, b0=b0, dtype=dtype
    )
    if cfg.precond_dtype is not None and cfg.cycle in (
        CycleType.MGCG, CycleType.MGFGMRES
    ):
        import dataclasses

        pcfg = dataclasses.replace(
            cfg, dtype=cfg.precond_dtype, precond_dtype=None,
            outer_dtype=None,
        )
        out.precond_ctx = build_context(pcfg, problem, plan=plan)
        assert [l.shapes for l in out.precond_ctx.levels] == [
            l.shapes for l in levels
        ], "precond context level shapes must match"
    return out
