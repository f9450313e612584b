"""Differentiate THROUGH a sparse solve: a tiny PDE-constrained inverse
problem.

Recover the source term ``b`` of a 2-D Poisson problem from an observed
solution ``x_obs``: minimize ``L(b) = 0.5 ||A^{-1} b - x_obs||^2``. Each
gradient is computed by the implicit function theorem
(``ops.autodiff.cg_solve_implicit`` -> ``lax.custom_linear_solve``): one
extra CG solve per gradient, never backprop through the CG iteration.

Plain gradient descent is hopeless here (the Hessian is ``A^{-2}``, whose
conditioning is Poisson's squared), so the loop preconditions the implicit
gradient with the Gauss-Newton metric ``(J^T J)^{-1} = A^2`` — two more
applications of the SAME sparse operator. Autodiff supplies the adjoint
solve; the operator supplies the metric; convergence is a couple of steps.

    python examples/autodiff_inverse_problem.py [grid_size] [steps]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from sparse_matrix_tpu.ops import SpmvOperator, cg_solve_implicit
from sparse_matrix_tpu.solvers import poisson_2d_csr


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    a = poisson_2d_csr(n)
    op = SpmvOperator(a)
    dofs = a.rows

    # ground truth: a smooth bump source, and the solution we "observed"
    rng = np.random.default_rng(0)
    xs = np.linspace(0, 1, n)
    bump = np.exp(-80 * ((xs[:, None] - 0.4) ** 2 + (xs[None, :] - 0.6) ** 2))
    b_true = jnp.asarray(bump.ravel().astype(np.float32))
    x_obs = cg_solve_implicit(op, b_true, tol=1e-7, maxiter=4000)

    @jax.jit
    def loss(b):
        x = cg_solve_implicit(op, b, tol=1e-6, maxiter=4000)
        r = x - x_obs
        return 0.5 * jnp.vdot(r, r)

    grad = jax.jit(jax.grad(loss))

    @jax.jit
    def gn_step(b):
        g = jax.grad(loss)(b)      # implicit: one adjoint CG solve
        return b - op(op(g))       # Gauss-Newton metric A^2, two SpMVs

    b = jnp.zeros(dofs, jnp.float32)
    for k in range(steps):
        b = gn_step(b)
        if k % 2 == 0 or k == steps - 1:
            rel = float(jnp.linalg.norm(b - b_true) / jnp.linalg.norm(b_true))
            print(f"step {k:3d}: loss={float(loss(b)):.3e}  |b-b*|/|b*|={rel:.4f}")

    rel = float(jnp.linalg.norm(b - b_true) / jnp.linalg.norm(b_true))
    print(f"recovered source with relative error {rel:.3f} "
          f"({steps} Gauss-Newton steps, each = 2 implicit CG solves + 2 SpMVs)")


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
