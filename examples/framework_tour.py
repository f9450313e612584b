"""Tour of the framework surface a `sparse_matrix` (Rust) user would reach
for, end to end on one page. Run: python examples/framework_tour.py

Covers: MatrixMarket I/O (incl. the variants the reference todo!()s),
DOK <-> CSR, elementwise ops, SpGEMM dispatch, planned SpMV operators,
solvers, plan persistence, and the accuracy oracle.
"""
import io
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from sparse_matrix_tpu.core import (
    DokMatrix,
    parse_matrix_market,
    to_matrix_market_string,
)
from sparse_matrix_tpu.core.accuracy import is_good_approx_of_mul
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.ops.operator import (
    SpmvOperator,
    load_operator_plan,
    save_operator_plan,
)
from sparse_matrix_tpu.ops.spgemm_block import spgemm_auto
from sparse_matrix_tpu.solvers import cg_solve, minres_solve, poisson_2d_csr

# --- MatrixMarket in (a skew-symmetric file: todo!() upstream, works here)
text = """%%MatrixMarket matrix coordinate real skew-symmetric
4 4 3
2 1 1.5
3 2 -0.5
4 1 2.0
"""
m = parse_matrix_market(text).matrix
print("parsed skew-symmetric:", m.shape, "nnz", m.nnz())

# --- DOK edits with reference semantics (old-value returns, zero deletion)
old = m.set_element((0, 3), np.float64(7.0))
print("set_element returned previous value:", old)

# --- CSR + elementwise + SpGEMM (engine picked by measured cost model)
a = CsrMatrix.from_dok(m)
s = a + a
c = spgemm_auto(a, a)
print("A+A nnz:", s.nnz(), "| A@A nnz:", c.nnz())
print("Higham bound holds:", is_good_approx_of_mul(c.to_dok(), m, m))

# --- round-trip persistence
rt = parse_matrix_market(to_matrix_market_string(c.to_dok())).matrix
assert rt == c.to_dok()
print("MatrixMarket round-trip: exact")

# --- planned SpMV operators: structure-aware format selection
p = poisson_2d_csr(64, dtype=np.float32)
op = SpmvOperator(p)  # banded -> DIA
print("poisson 64^2 operator format:", op.format)
rng = np.random.default_rng(0)
dense = (rng.random((600, 600)) < 0.02) * rng.standard_normal((600, 600))
g = CsrMatrix.from_dok(DokMatrix.from_dense(dense.astype(np.float32)))
opg = SpmvOperator(g)  # unstructured -> aligned or lanepack by cost
print("unstructured operator format:", opg.format)

# --- solvers on the operator (CG for SPD, MINRES for indefinite shifts)
b = rng.standard_normal(p.rows).astype(np.float32)
res = cg_solve(op, b, tol=1e-5)
print(f"CG: {int(res.iterations)} iters, residual {float(res.residual_norm):.2e}")
res2 = minres_solve(lambda v: op(v) - 3.0 * v, b, tol=1e-3, maxiter=4000)
print(
    f"MINRES (A-3I, indefinite): {int(res2.iterations)} iters, "
    f"residual {float(res2.residual_norm):.2e}"
)

# --- rectangular least squares (LSQR on A / A^T closures)
from sparse_matrix_tpu.solvers import lsqr_solve

tall = ((rng.random((200, 80)) < 0.1) * rng.standard_normal((200, 80))).astype(np.float32)
tall[:80] += np.eye(80, dtype=np.float32)
import jax.numpy as jnp

av = jnp.asarray(tall)
res3 = lsqr_solve(lambda v: av @ v, lambda u: av.T @ u,
                  jnp.asarray(rng.standard_normal(200).astype(np.float32)),
                  n=80, tol=1e-6, maxiter=400)
print(f"LSQR (200x80): {int(res3.iterations)} iters, "
      f"|A^T r| {float(res3.atr_norm):.2e}")

# --- reordering: recover locality for arbitrarily-numbered corpora
from sparse_matrix_tpu.formats import bandwidth, permute_symmetric, rcm_reordered

shuffled = permute_symmetric(p, rng.permutation(p.rows))
recovered, perm = rcm_reordered(shuffled)
print(f"RCM: bandwidth {bandwidth(shuffled)} -> {bandwidth(recovered)} "
      f"(solvers run in permuted space; x = x_perm un-permuted once)")

# --- amortized device SpGEMM engines (plan once, multiply repeatedly)
from sparse_matrix_tpu.ops.device_sorted import EscSpgemm

eng = EscSpgemm(g, g)
c_esc = eng.multiply()
assert np.allclose(c_esc.to_dense(), spgemm_auto(g, g).to_dense(), atol=1e-4)
print(f"EscSpgemm amortized: {eng.num_products} products -> nnz {c_esc.nnz()}")

# --- plan persistence (checkpoint/resume for operators)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "plan.npz")
    save_operator_plan(opg, path)
    op2 = load_operator_plan(path)
    x = rng.standard_normal(600).astype(np.float32)
    assert np.allclose(np.asarray(op2(x)), np.asarray(opg(x)))
    print("operator plan save/load: bitwise-identical apply")

# --- round 3: preconditioners, spectral tools, batched systems
from sparse_matrix_tpu.solvers import (
    chebyshev_solve, eigs, expm_multiply_csr, ic_pcg_solve, svds_csr,
    trace_estimate,
)

res_ic = ic_pcg_solve(p, b, sweeps=4, tol=1e-5, maxiter=2000)
print(f"IC(0)-PCG: {int(res_ic.iterations)} iters "
      f"(plain CG above took {int(res.iterations)})")

res_cheb = chebyshev_solve(op, b, n=p.rows, tol=1e-5, maxiter=3000)
print(f"Chebyshev (dot-free): {int(res_cheb.iterations)} iters")

sv = svds_csr(g, k=3)
print("top-3 singular values of the 600^2 matrix:", np.round(np.asarray(sv.s), 3))

vals_g, _ = eigs(SpmvOperator(g, dtype=np.float32), g.rows, k=2, m=40)
print("dominant |eig| (arnoldi):", np.round(np.abs(vals_g), 3))

heat = expm_multiply_csr(p, b, t=-0.1)
print(f"exp(-0.1 L) b: |y| = {float(np.linalg.norm(np.asarray(heat))):.3f} "
      f"(|b| = {np.linalg.norm(b):.3f})")

tr = trace_estimate(op, p.rows, probes=64)
print(f"Hutchinson trace(A) = {float(tr.estimate):.1f} "
      f"+- {float(tr.stderr):.1f} (exact {4.0 * p.rows:.1f})")

from sparse_matrix_tpu.ops import BatchedEllOperator, batched_cg_solve

pat = poisson_2d_csr(8, dtype=np.float32)
vals_b = np.stack([pat.vals * sc for sc in (0.5 + rng.random(16))]).astype(np.float32)
bres = batched_cg_solve(BatchedEllOperator(pat, vals_b),
                        rng.standard_normal((16, pat.rows)).astype(np.float32),
                        tol=1e-5, maxiter=200)
print(f"batched CG: 16 systems in one while_loop, "
      f"max iters {int(np.asarray(bres.iterations).max())}")

print("tour complete")
