"""Simulation core: functional state pytree + ONE jitted FSI timestep.

This replaces the reference's architecture (hand-written per-driver time
loops threading ~10 loose arrays through free functions — e.g.
benchmarks/soft_disc_in_lid_driven.py:78-123) with the idiomatic JAX shape:

    state' , aux = step(state, t_end)        # one compiled XLA program

The step performs the full RMT pipeline (parity with the reference loop):
  1. adaptive dt (compute_timestep), clipped to t_end,
  2. phi_i = phi_init_i(X1_i, X2_i) compatibility rebuild (+optional reinit),
  3. advect all 2S reference-map components (ONE shared semi-Lagrangian
     backtrace), reset the fluid side, re-extrapolate the narrow band,
  4. rebuild phi from the advected map,
  5. blended n-solid RK4 momentum step,
  6. mixture density + pressure projection (incremental, Rhie-Chow),
  7. t += dt.

S = 0 solids degenerates exactly to the pure-fluid Navier-Stokes solver
(Hf == 1, rho == rho_f), so the lid-driven cavity uses the same step.

Divergence handling: the reference raises FloatingPointError on non-finite
velocity (pyRMT/functions.py:460-465); under jit nothing can segfault, so
``diverged(state)`` exposes the same contract as a checkable predicate
(drivers poll it, mirroring two_disc_tg_collision.py:101-111).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from pyrmt_tpu.grid import Grid
from pyrmt_tpu.ops.advect import advect_reference_map_multi
from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map
from pyrmt_tpu.ops.levelset import reinitialize_level_set
from pyrmt_tpu.ops.poisson import (
    precompute_poisson_eigenvalues,
    precompute_poisson_eigenvalues_periodic,
)
from pyrmt_tpu.ops.projection import pressure_projection
from pyrmt_tpu.ops.stress import smoothed_heaviside
from pyrmt_tpu.physics import compute_timestep, momentum_step_rk4_multi


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """The whole simulation state as one pytree (device-resident)."""

    u: jax.Array           # (Ny, Nx)
    v: jax.Array           # (Ny, Nx)
    p: jax.Array           # (Ny, Nx)
    X1: jax.Array          # (S, Ny, Nx) reference-map x-components
    X2: jax.Array          # (S, Ny, Nx) reference-map y-components
    t: jax.Array           # scalar time
    step: jax.Array        # int32 step counter
    phis0: jax.Array = None  # (S, Ny, Nx) base level sets sampled by the
                             # interp rebuild when map rebasing is enabled
                             # (map_rebase_minj > 0). make_init_state always
                             # seeds an array — shape (0, Ny, Nx) when
                             # rebasing is off so the pytree stays uniform —
                             # and step() threads it through; the None
                             # default only covers direct construction by
                             # legacy callers/checkpoints (treated as the
                             # empty stack)


@dataclasses.dataclass(frozen=True)
class RMTConfig:
    """Static configuration — every field is a trace-time constant."""

    grid: Grid
    # physics
    mu_s: float = 0.0
    kappa: float = 0.0
    eta_s: float = 0.0
    rho_s: float = 1.0
    mu_f: float = 1.0
    rho_f: float = 1.0
    gamma: float = 0.0
    st_method: str = "csf"          # surface-tension discretisation:
                                    # 'csf' = reference-parity cell-centred
                                    # CSF f = -gamma*kappa*grad(H)
                                    # (pyRMT/functions.py:621-628);
                                    # 'balanced' = balanced-force CSF: the
                                    # capillary force is sampled compactly
                                    # at faces with the same stencil as the
                                    # face pressure jump and fed into BOTH
                                    # the momentum RHS (as the face average)
                                    # and the Rhie-Chow corrector — zero
                                    # parasitic currents to roundoff for a
                                    # face-constant curvature (see
                                    # physics.balanced_csf_forces). The
                                    # upgrade the reference names as its own
                                    # open follow-up and never implements
    st_kappa_interface: bool = False  # with st_method='balanced': project
                                    # each curvature sample to its nearest-
                                    # interface value kappa/(1 - phi*kappa)
                                    # (exact for ANY smooth interface under
                                    # an SDF phi — parallel-curve identity);
                                    # cuts the static-drop Laplace error ~6x
                                    # (see physics.balanced_csf_forces)
    st_curvature: str = "fd"        # curvature estimator for the CSF
                                    # forces: 'fd' = div(grad phi/|grad phi|)
                                    # (reference parity; combine with
                                    # st_kappa_interface for the interface-
                                    # projected kappa*), 'hf' = VOF-style
                                    # height functions over sharp solid
                                    # fractions reconstructed from phi
                                    # (ops/levelset.py:compute_curvature_hf;
                                    # falls back to fd/kappa* per cell where
                                    # its columns are invalid). Beyond
                                    # reference — the "better curvature
                                    # estimate" the reference names as its
                                    # open follow-up
    st_hf_smooth: int = 0           # > 0 stabilises 'hf' for COUPLED moving
                                    # interfaces: that many tangential
                                    # [1,2,1]/4 passes on the column heights
                                    # (linear-exact — straight interfaces
                                    # keep kappa = 0 exactly) plus a convex
                                    # validity/orientation blend replacing
                                    # the raw estimator's hard per-cell
                                    # switches, whose flicker under a
                                    # deforming rebuilt phi is what fed the
                                    # parasitic-current loop (raw 'hf'
                                    # diverges at t~0.44 on the coupled
                                    # capillary case; see
                                    # compute_curvature_hf and
                                    # benchmarks/README.md)
    g_x: float = 0.0               # gravitational acceleration; enters the
    g_y: float = 0.0                # momentum RHS as the BUOYANCY body force
                                    # (rho_local - g_rho_ref) * g — the
                                    # uniform rho_ref*g part is absorbed into
                                    # the pressure (standard for confined
                                    # incompressible flow; avoids the
                                    # hydrostatic-background transient a raw
                                    # rho*g force feeds through the Neumann
                                    # projection). Beyond-reference feature:
                                    # upstream has no body force at all;
                                    # enables the density-contrast benchmark
                                    # (benchmarks/density_contrast_disc.py)
    g_rho_ref: float | None = None  # reference density for buoyancy
                                    # (None -> rho_f, making the pure-fluid
                                    # region exactly force-free)
    w_t_cells: float = 2.0          # transition width in units of dx
    # numerics
    scheme: str = "semilagrangian"  # 'semilagrangian' | 'central2' | 'weno5'
    bc_type: str = "neumann"        # 'neumann' | 'periodic'
    reinit_method: str = "none"     # 'none' | 'pde' | 'fmm'
    reinit_iters: int = 20
    map_rebase_minj: float = 0.0    # > 0 enables in-graph reference-map
                                    # REBASING (Kamrin-Nave-style remapping
                                    # for fluid-like solids, BEYOND
                                    # REFERENCE): when min J drops below
                                    # this threshold the map is reset to
                                    # the identity, the current level set
                                    # (redistanced by fast sweeping) becomes
                                    # the new base phi0 carried in
                                    # SimState.phis0, and the rebuild
                                    # switches from the analytic phi_init
                                    # closures to bilinear sampling of
                                    # phis0 at the map. Resets the elastic
                                    # reference state — intended for
                                    # near-fluid solids (mu_s ~ 0) where
                                    # the map is an interface tracker;
                                    # kills the secular interior map
                                    # distortion that otherwise folds the
                                    # map under sustained large deformation
                                    # (benchmarks/README.md capillary row)
    map_rebase_rebuild: str = "cond"  # HOW the rebasing rebuild picks its
                                    # source: 'cond' (default) = the in-graph
                                    # per-solid lax.cond on phis0 != seed —
                                    # correct in every phase; 'analytic' =
                                    # always the analytic phi_init rebuild
                                    # (EXACT until the first rebase event
                                    # fires — triggers/rebasing still run
                                    # and update phis0; the driver must
                                    # switch to 'sampled' once
                                    # aux['rebased'] fires, see
                                    # make_rebase_runner); 'sampled' =
                                    # always bilinear phis0 sampling (the
                                    # post-rebase executable; identical to
                                    # 'cond' once every solid has rebased,
                                    # and to within bilinear sampling error
                                    # of the analytic rebuild before — do
                                    # not use it pre-trigger when exactness
                                    # matters)
    phi_area_fix: bool = False      # per-solid constant-shift level-set
                                    # mass fix after the rebuild(+reinit):
                                    # phi_i += c_i with c_i solved (2 Newton
                                    # steps) so the smoothed solid area
                                    # stays at its t=0 value — kills the
                                    # slow advection-error area drift that
                                    # ends the long-horizon coupled
                                    # capillary case (beyond reference; see
                                    # ops/levelset.py:area_conserving_shift)
    stress_band: bool = False
    detg_clamp: float = 3.0
    two_solid_clamp: float = 4.0    # legacy-mode clamp used when S >= 2
    num_layers: int = 3
    w_cut: float = 0.0
    k_rep: float = 0.0
    w_c_cells: float = 3.0          # contact half-width in units of dx
    CFL: float = 0.2
    dt_min_cap: float = 1e-3
    fixed_dt: float | None = None   # bypass compute_timestep entirely and
                                    # step with EXACTLY this dt (still clipped
                                    # at t_end). For fixed-dt convergence
                                    # studies where an adaptive constraint
                                    # (e.g. viscous ~dx^2) would silently bind
                                    # below the intended step at fine grids.
                                    # Caller must ensure stability AND the
                                    # sub-cell-displacement guard for
                                    # sl_local (advective CFL < 1).
    sl_local: bool = True           # gather-free semi-Lagrangian (needs CFL<1)
    sl_interp: str = "bilinear"     # final SL gather: 'bilinear' | 'bicubic'
                                    # (Catmull-Rom, the reference's inactive
                                    # variant pyRMT/functions.py:200; both
                                    # have gather-free local paths)
    sl_band_guard: float = 3.0      # bicubic band guard, in cells: reference-
                                    # map cells with phi > -guard*dx fall back
                                    # to the bilinear sample so bicubic's 4x4
                                    # stencil stays on REAL solid data. The
                                    # guard is evaluated at the TARGET cell's
                                    # phi while the stencil is centred on the
                                    # DEPARTURE point, so it assumes sub-cell
                                    # displacements (guaranteed on the default
                                    # sl_local path by CFL < 1): worst-case
                                    # stencil reach is then (1+2)*sqrt(2) ≈
                                    # 4.24 dx diagonally, vs the ~3 dx the
                                    # default covers plus phi's own negative
                                    # margin at guarded cells — empirically
                                    # sufficient on every recorded case, but
                                    # NOT an airtight bound; with
                                    # sl_local=False or CFL >= 1 the
                                    # displacement is unbounded and the guard
                                    # can under-cover (make_step warns).
                                    # Without the guard, a thin squeezed solid
                                    # (soft-disc vs the lid, t≈5) puts
                                    # colliding extrapolations from opposite
                                    # interface lobes inside one stencil and
                                    # the advected map folds (J < 0) —
                                    # measured, benchmarks/README.md. <= 0
                                    # disables (raw bicubic everywhere)
    dct_method: str = "auto"        # Neumann DCT-I lowering: 'fft' (rFFT of
                                    # the even extension) | 'matmul' (dense
                                    # even/odd-folded transform matrices) |
                                    # 'matmul_rec' (odd N, recursive fold —
                                    # fewest matmul FLOPs on 2^k+1 grids) |
                                    # 'auto' (= 'fft' on every platform)
    dct_precision: str = "auto"     # matmul precision of the matmul DCT
                                    # lowerings ('auto' | 'highest' | 'high'
                                    # | 'default'). 'auto' = 'highest' on
                                    # every platform: the exact FFT-parity
                                    # transform. On a GPU 'default' is a
                                    # TF32 matmul (~3 decimal digits) and
                                    # is unvalidated; docs/DESIGN.md #6
    extrap_method: str = "auto"     # 'xla' (dense shift-add sweeps) |
                                    # 'sparse' (frontier gather with a dense
                                    # fallback) | 'auto' (= 'sparse')
    variable_rho: bool = False      # static: solid/fluid densities differ
    cg_tol: float = 1e-6
    cg_maxiter: int = 200

    @property
    def w_t(self) -> float:
        return self.w_t_cells * self.grid.dx

    @property
    def w_c(self) -> float:
        return self.w_c_cells * self.grid.dx


def _resolve_dct_mats(method: str, Nx: int, Ny: int, dtype):
    """Trace-time choice of the Neumann DCT lowering: 'fft' (and 'auto')
    keeps the rFFT-of-even-extension path (the reference-parity
    formulation); 'matmul'/'matmul_rec' return the dense transform
    matrices of ops/poisson.py."""
    if method in ("auto", "fft"):
        return None
    if method == "matmul":
        from pyrmt_tpu.ops.poisson import precompute_dct_matrices

        return precompute_dct_matrices(Nx, Ny, dtype=dtype)
    if method == "matmul_rec":
        from pyrmt_tpu.ops.poisson import precompute_dct_plan

        return precompute_dct_plan(Nx, Ny, dtype=dtype)
    raise ValueError(f"unknown dct_method {method!r}")


def _resolve_dct_precision(name: str) -> str | None:
    """'auto' -> 'highest': the exact FFT-parity transform (a no-op on the
    CPU; on a GPU it keeps f32 matmuls out of TF32)."""
    return "highest" if name == "auto" else name


def _resolve_extrap(method: str):
    """The narrow-band extrapolation of ``RMTConfig.extrap_method``
    ('auto' -> 'sparse'); shared by make_step and make_rebase_runner."""
    from pyrmt_tpu.ops.extrapolate import extrapolate_reference_map_sparse

    fns = {"auto": extrapolate_reference_map_sparse,
           "sparse": extrapolate_reference_map_sparse,
           "xla": extrapolate_reference_map}
    if method not in fns:
        raise ValueError(f"unknown extrap_method {method!r}")
    return fns[method]


def required_extrapolation_layers(w_t, dx):
    """ceil(w_t/dx) + 1 (parity: benchmarks/common.py:70-80)."""
    import math

    return int(math.ceil(w_t / dx)) + 1


def check_narrow_band(w_t, dx, num_layers):
    """Raise if the extrapolation band cannot cover the (1-H)>0 blend region
    (parity: benchmarks/common.py:83-91)."""
    need = required_extrapolation_layers(w_t, dx)
    if num_layers < need:
        raise ValueError(
            "Narrow-band inconsistency: w_t=%.4g (=%0.2f dx) needs >= %d "
            "extrapolation layers but only %d requested." % (w_t, w_t / dx, need, num_layers)
        )
    return need


def periodic_seam_clearance_cells(cfg: RMTConfig) -> int:
    """Cells of clearance a solid needs from every domain edge under
    ``bc_type='periodic'`` for the solid machinery to be seam-safe: the
    extrapolation band (num_layers), the wider of the Heaviside blend band
    and the bicubic band guard, plus 2 cells of gather/stencil reach. Both
    this framework and the reference clamp (rather than wrap) every solid
    gather/stencil at the domain edge — the reference's own periodic wrap
    (`/root/reference/pyRMT/functions.py:33-46`, apply_phi_BCs) is applied
    only at setup/reinit, never inside its interpolators — so a solid
    crossing the periodic seam is undefined behaviour in BOTH codes. Here
    it is rejected explicitly instead of silently corrupting the map."""
    import math

    guard = cfg.sl_band_guard if cfg.sl_interp == "bicubic" else 0.0
    band = max(math.ceil(cfg.w_t_cells), math.ceil(guard))
    return cfg.num_layers + band + 2


def solid_near_periodic_seam(phis, clear_cells: int):
    """In-graph predicate: any solid (phi <= 0) cell within ``clear_cells``
    of a domain edge (= the periodic seam). Drivers running periodic cases
    poll this on aux['phis'] alongside ``diverged`` — a True means the
    solid has drifted into the seam-clamped region and the run is no
    longer trustworthy (see periodic_seam_clearance_cells)."""
    k = int(clear_cells)
    solid = phis <= 0.0
    ring = jnp.zeros_like(solid)
    ring = ring.at[..., :k, :].set(True).at[..., -k:, :].set(True)
    ring = ring.at[..., :, :k].set(True).at[..., :, -k:].set(True)
    return jnp.any(solid & ring)


def check_periodic_seam_clearance(cfg: RMTConfig, phi_inits, dtype):
    """Trace-time rejection (make_init_state): under periodic BCs every
    initial solid must clear the seam by ``periodic_seam_clearance_cells``
    — raises ValueError otherwise (the explicit alternative to the
    silent clamp-vs-wrap corruption both codes would otherwise produce)."""
    import numpy as np

    k = periodic_seam_clearance_cells(cfg)
    X, Y = cfg.grid.coords(dtype=dtype)
    for i, pi in enumerate(phi_inits):
        phi = np.asarray(pi(X, Y))
        solid = phi <= 0.0
        ring = np.zeros_like(solid)
        ring[:k, :] = ring[-k:, :] = True
        ring[:, :k] = ring[:, -k:] = True
        if bool(np.any(solid & ring)):
            raise ValueError(
                f"bc_type='periodic': solid {i} starts within {k} cells of "
                "the periodic seam. Neither this framework nor the "
                "reference supports a solid crossing the seam (all solid "
                "gathers/stencils clamp at the domain edge); keep solids "
                f">= {k} cells clear, or use a larger domain. Poll "
                "sim.solid_near_periodic_seam during the run to detect "
                "drift into the seam."
            )


_TRACEABLE_PARAMS = ("mu_s", "kappa", "gamma", "rho_s", "rho_f")


def make_step(
    cfg: RMTConfig,
    velocity_bc: Callable,
    phi_inits: Sequence[Callable] = (),
    dtype=jnp.float32,
    traced_params: tuple[str, ...] | None = None,
):
    """Build the jitted FSI step for a fixed configuration.

    ``phi_inits`` is one analytic level-set function per solid,
    phi_i = phi_inits[i](X1_i, X2_i); an empty sequence gives the pure-fluid
    solver. Returns ``step(state, t_end) -> (state, aux)``.

    ``traced_params`` names physics scalars the step takes as a RUNTIME
    dict instead of baking cfg's floats: the returned function is then
    ``step(state, t_end, params) -> (state, aux)`` with
    ``params = {'mu_s': ...}``, differentiable w.r.t. every named scalar
    (see diff.make_diff_step). Allowed names: ``mu_s, kappa, gamma, rho_s,
    rho_f`` (``mu_f``/``eta_s``/``k_rep`` stay compile-time: they gate the
    step's structure). STRUCTURAL choices (is surface tension on, dt caps'
    branches) still follow ``cfg``'s values — a traced value must not
    cross its cfg twin's enable thresholds (e.g. keep a traced gamma > 0
    iff cfg.gamma > 0). With ``traced_params=None`` cfg's floats are
    baked into the trace.
    """
    if traced_params is not None:
        bad = set(traced_params) - set(_TRACEABLE_PARAMS)
        if bad:
            raise ValueError(
                f"traced_params {sorted(bad)} not traceable; allowed: "
                f"{_TRACEABLE_PARAMS}")
    g = cfg.grid
    dx, dy = g.dx, g.dy
    S = len(phi_inits)
    if S > 0:
        need = check_narrow_band(cfg.w_t, dx, cfg.num_layers)
        if cfg.stress_band and cfg.num_layers < need + 1:
            # Band-mode stability rule (measured, benchmarks/README.md):
            # the banded central stress differentiates the OUTERMOST
            # extrapolated ring, and this framework's layer-synchronous
            # extrapolation (docs/DESIGN.md deviation) leaves that ring
            # lower-quality than the reference's in-layer-cascading serial
            # fits — soft-disc-in-lid destabilises at num_layers=3
            # (blow-up t~3.8) but is stable from 4 up (KE converged).
            import warnings

            warnings.warn(
                f"stress_band=True with num_layers={cfg.num_layers}: the "
                f"banded stress reads the outermost extrapolation ring; "
                f"use num_layers >= {need + 1} (= ceil(w_t/dx)+2) for "
                f"stability on demanding flows (see benchmarks/README.md).",
                stacklevel=2,
            )
        if (cfg.sl_interp == "bicubic" and cfg.sl_band_guard > 0.0
                and (not cfg.sl_local or cfg.CFL >= 1.0)):
            # The band guard's coverage argument assumes sub-cell departure
            # displacements (see the sl_band_guard field docs); on the
            # general gather path / CFL >= 1 the displacement is unbounded.
            import warnings

            warnings.warn(
                "sl_interp='bicubic' with sl_local=False or CFL >= 1: the "
                "band guard assumes sub-cell departure displacements and "
                "can under-cover here — raise sl_band_guard or use "
                "bilinear.",
                stacklevel=2,
            )
    X, Y = g.coords(dtype=dtype)
    has_gravity = cfg.g_x != 0.0 or cfg.g_y != 0.0
    g_rho_ref = cfg.rho_f if cfg.g_rho_ref is None else cfg.g_rho_ref
    if cfg.st_method not in ("csf", "balanced"):
        raise ValueError(f"unknown st_method {cfg.st_method!r}")
    if cfg.st_curvature not in ("fd", "hf"):
        raise ValueError(f"unknown st_curvature {cfg.st_curvature!r}")
    if (cfg.st_curvature == "hf" and cfg.gamma > 1e-12 and S > 0
            and cfg.st_hf_smooth == 0):
        # make_step IS the coupled moving-interface path (the static-drop
        # driver bypasses it): under the deforming rebuilt phi the RAW
        # height-function estimator's jagged per-cell kappa feeds the
        # parasitic loop faster than the smooth fd/kappa* band estimate —
        # measured divergence at t~0.44 on the coupled capillary case with
        # or without reinit (benchmarks/README.md, Estimator arbitration).
        # st_hf_smooth > 0 is the stabilised variant built for this regime
        # (tangential height filtering + convex validity/orientation blend)
        # and does not warn.
        import warnings

        warnings.warn(
            "st_curvature='hf' (raw, st_hf_smooth=0) on a COUPLED moving "
            "interface: the raw height-function estimator is measured to "
            "destabilise the coupled capillary case at t~0.44 "
            "(benchmarks/README.md); set st_hf_smooth=2 (the stabilised "
            "estimator) or use st_curvature='fd' with "
            "st_kappa_interface=True (kappa*) for coupled flows.",
            stacklevel=2,
        )
    st_balanced = cfg.st_method == "balanced" and cfg.gamma > 1e-12
    if st_balanced and cfg.bc_type != "neumann":
        raise ValueError(
            "st_method='balanced' requires the incremental Neumann "
            "(Rhie-Chow) projection (bc_type='neumann')")

    if cfg.bc_type == "periodic":
        eig = precompute_poisson_eigenvalues_periodic(g.Nx, g.Ny, dx, dy, dtype=dtype)
        dct_mats = None
    else:
        eig = precompute_poisson_eigenvalues(g.Nx, g.Ny, dx, dy, dtype=dtype)
        dct_mats = _resolve_dct_mats(cfg.dct_method, g.Nx, g.Ny, dtype)
    dct_prec = _resolve_dct_precision(cfg.dct_precision)

    # stress mode: single solid follows stress_band; multi-solid uses the
    # legacy interior stress with the collision clamp (reference behaviour)
    if S >= 2:
        stress_w_cut = 0.0
        stress_clamp = cfg.two_solid_clamp
    else:
        stress_w_cut = cfg.w_t if cfg.stress_band else 0.0
        stress_clamp = cfg.detg_clamp if cfg.stress_band else 0.0

    extrap_fn = _resolve_extrap(cfg.extrap_method)

    rebasing = cfg.map_rebase_minj > 0.0 and S > 0
    if rebasing:
        from pyrmt_tpu.ops.interp import bilinear_interpolate
        from pyrmt_tpu.ops.levelset import reinitialize_phi_fsm

        # Trace-time base level sets: phis0 starts as EXACTLY these arrays
        # (make_init_state seeds phi_init(X, Y) in the sim dtype) and only
        # a rebase event ever rewrites a solid's slot. Comparing against
        # them is the per-step "has this solid rebased yet?" predicate.
        seeds = tuple(jnp.asarray(pi(X, Y), dtype) for pi in phi_inits)

        if cfg.map_rebase_rebuild not in ("cond", "analytic", "sampled"):
            raise ValueError(
                f"unknown map_rebase_rebuild {cfg.map_rebase_rebuild!r}")
        rebuild_mode = cfg.map_rebase_rebuild

        def rebuild_phis(X1s, X2s, phis0):
            # phi_i(x) = phi0_i(xi_i(x)): sample the CURRENT base level set
            # at the map. The generalization of the reference's analytic
            # rebuild (pyRMT/functions.py:1287-1288) to a non-analytic
            # phi0. UNTIL a solid's first rebase event phis0_i is still the
            # analytic seed, so mode 'cond' uses the ANALYTIC rebuild then
            # (exact — bitwise-identical to rebasing-off) and switches to
            # bilinear phis0 sampling per solid once a rebase has rewritten
            # it. Modes 'analytic'/'sampled' pin one source uncondition-
            # ally (the two executables of make_rebase_runner, which
            # switches between them at chunk granularity).
            outs = []
            for i in range(S):
                if rebuild_mode == "analytic":
                    outs.append(jnp.asarray(
                        phi_inits[i](X1s[i], X2s[i]), dtype))
                elif rebuild_mode == "sampled":
                    outs.append(bilinear_interpolate(
                        phis0[i], X1s[i], X2s[i], dx, dy))
                else:
                    sampled = jnp.any(phis0[i] != seeds[i])
                    outs.append(jax.lax.cond(
                        sampled,
                        lambda p0, x1, x2: bilinear_interpolate(
                            p0, x1, x2, dx, dy),
                        lambda p0, x1, x2, i=i: jnp.asarray(
                            phi_inits[i](x1, x2), p0.dtype),
                        phis0[i], X1s[i], X2s[i],
                    ))
            return jnp.stack(outs)

        def maybe_rebase(X1s, X2s, phis, J_s, phis0, active):
            # In-graph min-J trigger (see RMTConfig.map_rebase_minj): when a
            # solid's minimum J over its interior drops below the threshold,
            # reset its map to the identity, redistance its CURRENT level
            # set by fast sweeping into the new base phi0, and re-extrapolate
            # the identity map over the narrow band. lax.cond pays the
            # redistance+extrapolation only on triggering steps. J == 1 at
            # the identity, so a rebase cannot re-trigger immediately.
            # Mode 'analytic' (the runner's PRE-rebase executable) carries
            # phis0 untouched and never triggers in-graph: a fired rebase
            # would make the unconditional analytic rebuild WRONG (the
            # original shape at the original position), so triggering is
            # the runner's job there (make_rebase_runner: min-J check +
            # host-initiated rebase at chunk boundaries).
            if rebuild_mode == "analytic":
                return (X1s, X2s, phis0,
                        jnp.zeros((S,), bool))
            big = jnp.asarray(jnp.inf, J_s.dtype)
            X1_out, X2_out, p0_out, flags = [], [], [], []
            for i in range(S):
                minJ = jnp.min(jnp.where(phis[i] <= 0.0, J_s[i], big))
                trig = (minJ < cfg.map_rebase_minj) & active

                def do_rebase(_, i=i):
                    phi0n = reinitialize_phi_fsm(phis[i], dx, dy)
                    mask = (phi0n <= 0.0).astype(dtype)
                    X1n, X2n = extrap_fn(
                        X * mask, Y * mask, phi0n, dx, dy, cfg.num_layers)
                    return X1n, X2n, phi0n

                def keep(_, i=i):
                    return X1s[i], X2s[i], phis0[i]

                X1n, X2n, p0n = jax.lax.cond(trig, do_rebase, keep, None)
                X1_out.append(X1n)
                X2_out.append(X2n)
                p0_out.append(p0n)
                flags.append(trig)
            return (jnp.stack(X1_out), jnp.stack(X2_out),
                    jnp.stack(p0_out), jnp.stack(flags))
    else:
        def rebuild_phis(X1s, X2s, phis0=None):
            return jnp.stack(
                [phi_inits[i](X1s[i], X2s[i]) for i in range(S)]
            ) if S else jnp.zeros((0,) + g.shape, dtype)

    if cfg.phi_area_fix and S > 0:
        # per-solid target areas, concrete at trace time (the t=0 rebuild at
        # the identity map IS phi_init(X, Y))
        from pyrmt_tpu.ops.levelset import (
            area_conserving_shift,
            smoothed_solid_area,
        )

        area_targets = tuple(
            float(smoothed_solid_area(
                jnp.asarray(pi(X, Y), dtype), dx, dy, cfg.w_t))
            for pi in phi_inits)

        def fix_areas(phis):
            return jnp.stack([
                area_conserving_shift(
                    phis[i], dx, dy, cfg.w_t, area_targets[i])
                for i in range(S)
            ])

    def _step(state: SimState, t_end, pp):
        u, v, p = state.u, state.v, state.p
        X1s, X2s = state.X1, state.X2

        if cfg.fixed_dt is not None:
            dt = jnp.asarray(cfg.fixed_dt, dtype)
        else:
            dt = compute_timestep(
                u, v, dx, dy, cfg.CFL, cfg.dt_min_cap, pp.mu_s, pp.rho_s,
                pp.gamma, pp.rho_f, mu_f=cfg.mu_f, eta_s=cfg.eta_s,
                kappa=pp.kappa,
            )
        dt = jnp.minimum(dt, jnp.maximum(t_end - state.t, 0.0)).astype(dtype)
        # Once t reaches t_end the clipped dt is 0 and the projection's
        # rho*div/dt would produce NaNs; run the step with a safe dt and
        # freeze the state afterwards, so scanned chunks can overrun t_end
        # as no-ops (the reference's while-loop never steps past t_end).
        active = dt > 0.0
        dt = jnp.where(active, dt, jnp.asarray(1.0, dtype))

        if S > 0:
            # (2) compatibility rebuild (+ optional reinitialisation)
            phis = rebuild_phis(X1s, X2s, state.phis0)
            if cfg.reinit_method != "none":
                phis = jnp.stack([
                    reinitialize_level_set(
                        phis[i], dx, dy, method=cfg.reinit_method,
                        num_iters=cfg.reinit_iters,
                    )
                    for i in range(S)
                ])
            if cfg.phi_area_fix:
                phis = fix_areas(phis)
            solid_masks = (phis <= 0.0).astype(dtype)

            # (3) advect all reference-map components; the semi-Lagrangian
            # backtrace is field-independent so all 2S components share it
            if cfg.scheme == "semilagrangian":
                from pyrmt_tpu.ops.advect import advect_semilagrangian_rk4_local

                qs = jnp.concatenate([X1s, X2s], axis=0)
                if cfg.sl_interp == "bicubic" and cfg.sl_band_guard > 0.0:
                    # band guard: bicubic only where the whole 4x4 stencil
                    # sits on REAL solid data (phi <= 0); the extrapolated
                    # band keeps the bilinear sample (sl_band_guard docs)
                    m = phis < (-cfg.sl_band_guard * max(dx, dy))
                    cubic_mask = jnp.concatenate([m, m], axis=0)
                else:
                    cubic_mask = None
                if cfg.sl_local and cfg.CFL < 1.0:
                    # gather-free fast path: CFL bounds the backtrace to <1
                    # cell, so the sampling (bilinear or bicubic final
                    # gather) is shifts+selects
                    qs_new = advect_semilagrangian_rk4_local(
                        qs, u, v, dt, dx, dy, interp=cfg.sl_interp,
                        cubic_mask=cubic_mask,
                    )
                else:
                    qs_new = advect_reference_map_multi(
                        qs, u, v, X, Y, dt, dx, dy, None, cfg.scheme,
                        cfg.w_cut, sl_interp=cfg.sl_interp,
                        sl_cubic_mask=cubic_mask,
                    )
                X1s_a, X2s_a = qs_new[:S], qs_new[S:]
            else:
                X1s_a = jnp.stack([
                    advect_reference_map_multi(
                        X1s[i : i + 1], u, v, X, Y, dt, dx, dy, phis[i],
                        cfg.scheme, cfg.w_cut,
                    )[0]
                    for i in range(S)
                ])
                X2s_a = jnp.stack([
                    advect_reference_map_multi(
                        X2s[i : i + 1], u, v, X, Y, dt, dx, dy, phis[i],
                        cfg.scheme, cfg.w_cut,
                    )[0]
                    for i in range(S)
                ])
            X1s_a = X1s_a * solid_masks
            X2s_a = X2s_a * solid_masks

            ext = [
                extrap_fn(X1s_a[i], X2s_a[i], phis[i], dx, dy, cfg.num_layers)
                for i in range(S)
            ]
            X1s = jnp.stack([e[0] for e in ext])
            X2s = jnp.stack([e[1] for e in ext])
            # freeze the maps on no-op (dt clamped to 0) steps so every
            # downstream quantity (stress, J, phi, density) reflects the
            # unchanged state
            X1s = jnp.where(active, X1s, state.X1)
            X2s = jnp.where(active, X2s, state.X2)

            # (4) rebuild phi from the advected map (the field every
            # downstream consumer — forces, mixture density, aux — sees;
            # the area fix must reapply here, not just at (2))
            phis = rebuild_phis(X1s, X2s, state.phis0)
            if cfg.phi_area_fix:
                phis = fix_areas(phis)
        else:
            phis = jnp.zeros((0,) + g.shape, dtype)

        # (5) momentum (with st_method='balanced' the CSF forces are built
        # here so the projection can reuse the face-sampled capillary terms)
        st_faces = None
        ext_override = None
        if S > 0 and st_balanced:
            from pyrmt_tpu.physics import balanced_csf_forces, external_forces

            H_st = smoothed_heaviside(phis, cfg.w_t)
            fxc, fyc, Fxf, Fyf = balanced_csf_forces(
                phis, H_st, dx, dy, pp.gamma,
                kappa_interface=cfg.st_kappa_interface,
                curvature=cfg.st_curvature, w_t=cfg.w_t,
                hf_smooth=cfg.st_hf_smooth)
            cfx, cfy = external_forces(
                phis, H_st, dx, dy, gamma=0.0, k_rep=cfg.k_rep,
                w_c=cfg.w_c, w_t=cfg.w_t)
            ext_override = (fxc + cfx, fyc + cfy)
            st_faces = (Fxf, Fyf, fxc, fyc)
        u_star, v_star, sxx_s, sxy_s, syy_s, J_s = momentum_step_rk4_multi(
            u, v, p, X1s, X2s, phis, velocity_bc,
            mu_s=pp.mu_s, kappa=pp.kappa, eta_s=cfg.eta_s, dx=dx, dy=dy,
            dt=dt, rho_s=pp.rho_s, rho_f=pp.rho_f, mu_f=cfg.mu_f,
            w_t=cfg.w_t, gamma=pp.gamma, stress_w_cut=stress_w_cut,
            st_enabled=cfg.gamma > 1e-12,
            stress_clamp=stress_clamp, k_rep=cfg.k_rep, w_c=cfg.w_c,
            g_x=cfg.g_x, g_y=cfg.g_y,
            g_rho_ref=(pp.rho_f if cfg.g_rho_ref is None else g_rho_ref),
            ext_override=ext_override,
            st_curvature=cfg.st_curvature,
            st_kappa_interface=cfg.st_kappa_interface,
            st_hf_smooth=cfg.st_hf_smooth,
            periodic=cfg.bc_type == "periodic",
        )

        # (5b) map rebasing: reset folding maps to the identity against a
        # redistanced base level set (RMTConfig.map_rebase_minj). Runs AFTER
        # this step's physics (which used the pre-rebase maps) so the rebased
        # maps flow into the NEXT step.
        phis0_new = state.phis0
        if rebasing:
            X1s, X2s, phis0_new, rebase_flags = maybe_rebase(
                X1s, X2s, phis, J_s, state.phis0, active)

        # (6) projection with the mixture density
        if S > 0:
            H_s = smoothed_heaviside(phis, cfg.w_t)
            Hf = jnp.sum(H_s, axis=0) - (S - 1.0)
            rho_local = Hf * pp.rho_f + jnp.sum(1.0 - H_s, axis=0) * pp.rho_s
        else:
            rho_local = jnp.full(g.shape, pp.rho_f, dtype)

        proj_out = pressure_projection(
            u_star, v_star, dx, dy, dt, rho_local, velocity_bc,
            p_prev=p, eigenvalues=eig, bc_type=cfg.bc_type,
            variable_rho=cfg.variable_rho, cg_tol=cfg.cg_tol,
            cg_maxiter=cfg.cg_maxiter, dct_mats=dct_mats,
            dct_precision=dct_prec, cg_info=cfg.variable_rho,
            st_faces=st_faces,
        )
        u_new, v_new, p_new = proj_out[:3]

        frz = lambda new, old: jnp.where(active, new, old)
        new_state = SimState(
            u=frz(u_new, state.u), v=frz(v_new, state.v),
            p=frz(p_new, state.p), X1=X1s, X2=X2s,
            t=state.t + jnp.where(active, dt, 0.0).astype(dtype),
            step=state.step + jnp.where(active, 1, 0).astype(jnp.int32),
            phis0=phis0_new,
        )
        aux = {
            "dt": jnp.where(active, dt, 0.0).astype(dtype),
            "phis": phis,
            "J": J_s,
            "sxx": sxx_s,
            "sxy": sxy_s,
            "syy": syy_s,
            "rho_local": rho_local,
        }
        if cfg.variable_rho:
            aux["cg_iters"], aux["cg_relres"] = proj_out[3]
        if rebasing:
            aux["rebased"] = rebase_flags
        return new_state, aux

    from types import SimpleNamespace

    base_params = {k: getattr(cfg, k) for k in _TRACEABLE_PARAMS}
    if traced_params is None:
        # cfg's own Python floats -> the trace (and therefore the compiled
        # executable) is byte-for-byte the pre-traced_params build
        pp0 = SimpleNamespace(**base_params)

        @jax.jit
        def step(state: SimState, t_end):
            return _step(state, t_end, pp0)
    else:
        names = tuple(traced_params)

        @jax.jit
        def step(state: SimState, t_end, params):
            merged = dict(base_params)
            for k in names:
                merged[k] = params[k]
            return _step(state, t_end, SimpleNamespace(**merged))

    return step


def make_init_state(
    cfg: RMTConfig,
    phi_inits: Sequence[Callable] = (),
    u0=None,
    v0=None,
    dtype=jnp.float32,
):
    """Initial state: reference maps seeded with the identity inside each
    solid and extrapolated ``num_layers`` into the fluid (the same setup as
    every reference driver)."""
    g = cfg.grid
    if cfg.bc_type == "periodic" and len(phi_inits) > 0:
        check_periodic_seam_clearance(cfg, phi_inits, dtype)
    X, Y = g.coords(dtype=dtype)
    S = len(phi_inits)
    zeros = jnp.zeros(g.shape, dtype)
    u = zeros if u0 is None else jnp.asarray(u0, dtype)
    v = zeros if v0 is None else jnp.asarray(v0, dtype)

    X1_list, X2_list, phi0_list = [], [], []
    for i in range(S):
        phi = jnp.asarray(phi_inits[i](X, Y), dtype)
        mask = (phi <= 0.0).astype(dtype)
        X1e, X2e = extrapolate_reference_map(
            X * mask, Y * mask, phi, g.dx, g.dy, cfg.num_layers
        )
        X1_list.append(X1e)
        X2_list.append(X2e)
        phi0_list.append(phi)
    X1s = jnp.stack(X1_list) if S else jnp.zeros((0,) + g.shape, dtype)
    X2s = jnp.stack(X2_list) if S else jnp.zeros((0,) + g.shape, dtype)
    # base level sets for map rebasing: at t=0 the rebuild at the identity
    # map must reproduce the analytic phi_init exactly, so seed with it
    # as-is (redistancing only happens at rebase events)
    rebasing = cfg.map_rebase_minj > 0.0 and S > 0
    phis0 = (jnp.stack(phi0_list) if rebasing
             else jnp.zeros((0,) + g.shape, dtype))

    return SimState(
        u=u, v=v, p=zeros, X1=X1s, X2=X2s,
        t=jnp.zeros((), dtype), step=jnp.zeros((), jnp.int32),
        phis0=phis0,
    )


def diverged(state: SimState, umax_cap=1.0e3):
    """Blow-up predicate: non-finite fields or |u| above the cap
    (parity contract: pyRMT/functions.py:460-465 +
    benchmarks/two_disc_tg_collision.py:107-111)."""
    umax = jnp.max(jnp.sqrt(state.u**2 + state.v**2))
    finite = (
        jnp.all(jnp.isfinite(state.u))
        & jnp.all(jnp.isfinite(state.v))
        & jnp.all(jnp.isfinite(state.p))
        & jnp.all(jnp.isfinite(state.X1))
        & jnp.all(jnp.isfinite(state.X2))
    )
    return (~finite) | (umax > umax_cap)


def run_until(step_fn, state: SimState, t_end, max_steps=10**8, callback=None):
    """Host-driven loop: one jitted step per iteration, with an optional
    per-step host callback (diagnostics/IO). Stops at t_end or divergence."""
    n = 0
    while float(state.t) < t_end and n < max_steps:
        state, aux = step_fn(state, t_end)
        n += 1
        if callback is not None:
            callback(state, aux)
        if bool(diverged(state)):
            return state, True
    return state, False


def make_run_chunk(step_fn, n_steps: int, donate: bool = False):
    """Compile ``n_steps`` adaptive-dt steps into ONE XLA program via
    lax.scan — zero host round-trips (the benchmarking / production path).
    Returns ``(state, t_final)``: the per-step time history is NOT stacked
    (no caller consumes it, and it would add a dynamic-update-slice to
    every step).

    ``donate=True`` donates the INPUT state's buffers to the output
    (jit donate_argnums), dropping one full SimState from the peak live
    footprint. The caller must then CHAIN states
    (``state = chunk(state, t)[0]``) — the passed-in state's arrays are
    deleted."""

    @partial(jax.jit, donate_argnums=(0,) if donate else ())
    def run_chunk(state: SimState, t_end):
        def body(s, _):
            s2, _aux = step_fn(s, t_end)
            return s2, None

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out, out.t

    return run_chunk


def make_rebase_runner(cfg, velocity_bc, phi_inits, n_steps: int,
                       dtype=jnp.float32, donate: bool = False):
    """Chunked runner for map-rebasing configs with no per-step cond in
    the rebuild.

    Builds TWO executables of the same physics differing only in
    ``map_rebase_rebuild``: the 'analytic' PRE-rebase step (gather-free; NO
    in-graph triggering) and the 'sampled' POST-rebase step (bilinear
    phis0 sampling every rebuild, in-graph maybe_rebase for subsequent
    triggers — consistent there because the sampled rebuild follows
    phis0). In the pre phase the RUNNER owns the trigger: after each
    scanned chunk it recomputes per-solid min J (one small jitted
    reduction), and on a firing threshold performs the rebase itself (FSM
    redistance + identity re-extrapolation, the exact maybe_rebase recipe
    replayed once at the chunk boundary) and switches executables
    permanently.

    The in-graph 'cond' rebuild (default make_step) keeps a per-solid
    ``lax.cond`` with a bilinear-gather branch inside every scanned step;
    this runner removes it at the price of ONE semantic concession: in the
    pre phase a trigger is detected at the END of the chunk it occurs in
    (latency <= n_steps steps), and the first trigger switches EVERY
    solid's rebuild to sampled. Keep rebasing chunks modest (100-500
    steps) so the lag is bounded; use ``map_rebase_rebuild='cond'`` when
    step-exact triggering matters.

    Returns ``run(state, t_end) -> (state, t)`` — same contract as
    :func:`make_run_chunk`.
    """
    S = len(phi_inits)
    if not (cfg.map_rebase_minj > 0.0 and S > 0):
        raise ValueError("make_rebase_runner requires map_rebase_minj > 0 "
                         "and at least one solid")
    pre_step = make_step(
        dataclasses.replace(cfg, map_rebase_rebuild="analytic"),
        velocity_bc, phi_inits, dtype=dtype)
    post_step = make_step(
        dataclasses.replace(cfg, map_rebase_rebuild="sampled"),
        velocity_bc, phi_inits, dtype=dtype)
    pre_chunk = make_run_chunk(pre_step, n_steps, donate=donate)
    post_chunk = make_run_chunk(post_step, n_steps, donate=donate)

    g = cfg.grid
    dx, dy = g.dx, g.dy
    X, Y = g.coords(dtype=dtype)

    # trigger detection + the rebase itself, replayed OUTSIDE the scan:
    # same stress mode, phi chain (area fix) and extrapolation lowering as
    # make_step
    from pyrmt_tpu.ops.levelset import reinitialize_phi_fsm
    from pyrmt_tpu.ops.stress import solid_cauchy_stress

    if cfg.phi_area_fix:
        from pyrmt_tpu.ops.levelset import (
            area_conserving_shift,
            smoothed_solid_area,
        )

        _targets = tuple(
            float(smoothed_solid_area(
                jnp.asarray(pi(X, Y), dtype), dx, dy, cfg.w_t))
            for pi in phi_inits)

        def _fix(phi, i):
            return area_conserving_shift(phi, dx, dy, cfg.w_t, _targets[i])
    else:
        def _fix(phi, i):
            return phi

    if S >= 2:
        s_w_cut, s_clamp = 0.0, cfg.two_solid_clamp
    else:
        s_w_cut = cfg.w_t if cfg.stress_band else 0.0
        s_clamp = cfg.detg_clamp if cfg.stress_band else 0.0
    _extrap = _resolve_extrap(cfg.extrap_method)

    @jax.jit
    def _min_J(state):
        big = jnp.asarray(jnp.inf, dtype)
        mins = []
        for i in range(S):
            phi = _fix(jnp.asarray(
                phi_inits[i](state.X1[i], state.X2[i]), dtype), i)
            _, _, _, J = solid_cauchy_stress(
                state.X1[i], state.X2[i], dx, dy, cfg.mu_s, cfg.kappa, phi,
                w_cut=s_w_cut, detg_clamp=s_clamp)
            mins.append(jnp.min(jnp.where(phi <= 0.0, J, big)))
        return jnp.stack(mins)

    def _rebase(state, fire):
        # host-initiated per-solid rebase (the runner's analogue of the
        # in-graph maybe_rebase, run ONCE at a chunk boundary)
        X1n, X2n, p0n = [], [], []
        for i in range(S):
            if fire[i]:
                phi = _fix(jnp.asarray(
                    phi_inits[i](state.X1[i], state.X2[i]), dtype), i)
                phi0 = reinitialize_phi_fsm(phi, dx, dy)
                mask = (phi0 <= 0.0).astype(dtype)
                x1, x2 = _extrap(X * mask, Y * mask, phi0, dx, dy,
                                 cfg.num_layers)
                X1n.append(x1)
                X2n.append(x2)
                p0n.append(phi0)
            else:
                X1n.append(state.X1[i])
                X2n.append(state.X2[i])
                p0n.append(state.phis0[i])
        return dataclasses.replace(
            state, X1=jnp.stack(X1n), X2=jnp.stack(X2n),
            phis0=jnp.stack(p0n))

    phase = {"post": False}

    def run(state: SimState, t_end):
        if not phase["post"]:
            state, t = pre_chunk(state, t_end)
            minJ = _min_J(state)
            fire = [bool(m < cfg.map_rebase_minj) for m in minJ]
            if any(fire):
                state = _rebase(state, fire)
                phase["post"] = True
            return state, t
        return post_chunk(state, t_end)

    return run


def make_rollout(step_fn, n_steps: int, remat: bool = True):
    """Differentiable ``n_steps``-step rollout (BEYOND REFERENCE).

    Like :func:`make_run_chunk` this compiles the whole trajectory into ONE
    XLA program via ``lax.scan``, but it is built for ``jax.grad`` /
    ``jax.vmap`` composition: with ``remat=True`` (default) each step is
    wrapped in ``jax.checkpoint`` so reverse-mode AD stores one SimState per
    step and recomputes the step's internals on the backward pass — memory
    O(n_steps * state) instead of O(n_steps * every-intermediate). Forward
    values are bitwise-identical to ``make_run_chunk`` (remat only changes
    what is saved for the backward pass; pinned in tests/test_diff.py).

    ``variable_rho=True`` is fully differentiable: the CG projection's
    ``lax.while_loop`` (no reverse-mode rule) is wrapped in an
    implicit-adjoint ``jax.custom_vjp`` that solves the self-adjoint
    system once on the backward pass
    (ops/poisson.solve_variable_poisson_cg_counted, tests/test_diff.py).
    To differentiate w.r.t. a *physics* scalar (mu_s, kappa, gamma,
    rho_s, rho_f), build the step with ``make_step(traced_params=(...))``:
    the scalars become a runtime dict argument, ONE compiled program
    serves every parameter value (no per-value retrace), and the
    adaptive-timestep dependence differentiates too (demonstrated
    end-to-end in examples/differentiable_fsi.py: inverse-stiffness
    recovery via diff.make_diff_step(param_names=...)). The older pattern
    — rebuilding inside the differentiated function with
    ``dataclasses.replace(cfg, mu_s=theta)`` — still works with
    ``fixed_dt`` (tests/test_diff.py) but retraces per value.

    The upstream NumPy/Numba stack has no gradient story at all; this is
    what the JAX-native architecture buys beyond speed.
    """
    if remat:
        inner = jax.checkpoint(lambda s, t_end: step_fn(s, t_end)[0])
    else:
        inner = lambda s, t_end: step_fn(s, t_end)[0]

    @jax.jit
    def rollout(state: SimState, t_end):
        def body(s, _):
            return inner(s, t_end), None

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out

    return rollout


def extrapolate_reference_map_compat(X1, X2, phi, dx, dy, max_layers):
    """Reference-signature compatibility alias."""
    return extrapolate_reference_map(X1, X2, phi, dx, dy, max_layers)
