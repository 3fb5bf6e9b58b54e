"""Box-constrained QP for control-limited iLQR (projected Newton).

The reference leaves control limits as a commented-out log-barrier in the
stage cost (`/root/reference/python/class_files/systems/pendulum_sys.py:84-85`,
`UA_double_pendulum_sys.py:122-123`).  This module implements hard limits the
DDP-native way (Tassa, Mansard & Todorov, ICRA 2014, see PAPERS.md): at each
backward-pass step solve

    min_d  ½ d'H d + g'd     s.t.  lo ≤ d ≤ hi

with a projected-Newton active-set iteration, and zero the feedback rows of
clamped controls.  Accelerator-shaped: a FIXED iteration count (no data-dependent
while_loop — vmaps/shards/scans cleanly), and the free-set subsystem is solved
by masking the clamped rows/columns to identity instead of gathering a
variable-size submatrix (static shapes; `solve_small` keeps n_u ≤ 4 solves on
the closed-form path).

For n_u = 1 one iteration is exact; for tiny n_u a handful of iterations
reaches the exact active set in practice (each iteration re-derives the set
from the projected gradient).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ilqr_tpu.models.base import f32_matmuls
from ilqr_tpu.ops.smallmat import solve_small

# Active-set changes per iteration are monotone-ish for convex H; 2·n_u + 1
# iterations covers the worst observed cases for n_u ≤ 4 with margin.
DEFAULT_ITERS = 8


@f32_matmuls
def boxqp(
    H: jnp.ndarray,
    g: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    iters: int = DEFAULT_ITERS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Minimize ½d'Hd + g'd subject to lo ≤ d ≤ hi (H SPD, small).

    Returns (d, free) where ``free`` is the float mask (1.0 on unclamped
    dimensions) defining the feedback subspace.
    """
    n = g.shape[-1]
    eye = jnp.eye(n, dtype=g.dtype)
    d0 = jnp.clip(jnp.zeros_like(g), lo, hi)

    def newton(d):
        grad = g + H @ d
        at_lo = (d <= lo + 1e-9) & (grad > 0)
        at_hi = (d >= hi - 1e-9) & (grad < 0)
        free = (~(at_lo | at_hi)).astype(g.dtype)
        # Clamped rows/cols → identity; solve stays full-size, static-shape.
        Hf = H * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        step = solve_small(Hf, -grad * free)
        return jnp.clip(d + step * free, lo, hi), free

    d, free = d0, jnp.ones_like(g)
    for _ in range(iters):
        d, free = newton(d)
    # Final activity for the feedback mask (gains live on the free subspace).
    grad = g + H @ d
    at_lo = (d <= lo + 1e-9) & (grad > 0)
    at_hi = (d >= hi - 1e-9) & (grad < 0)
    free = (~(at_lo | at_hi)).astype(g.dtype)
    return d, free


def boxqp_with_gains(
    H: jnp.ndarray,
    g: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    rhs: jnp.ndarray,
    iters: int = DEFAULT_ITERS,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """boxqp plus the free-subspace solve K = -H_ff⁻¹ rhs_f (clamped rows 0).

    ``rhs`` is (n_u, n_x) (Q_ux); returns (d, free, K).
    """
    d, free = boxqp(H, g, lo, hi, iters)
    Hf = H * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
    K = solve_small(Hf, -(rhs * free[:, None]))
    return d, free, K
