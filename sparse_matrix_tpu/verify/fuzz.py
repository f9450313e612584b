"""Deep differential fuzz loop — the libFuzzer ``mul_hash`` target analog
(``fuzz/fuzz_targets/mul_hash.rs:11-50``).

Each case:
  1. draws a conformable f64 DOK pair (dims up to ``max_dim``, values
     including NaN/inf when ``non_finite``);
  2. converts both through the adversarial shuffled-unsorted CSR path
     (``from_dok``, ``spam_csr/src/lib.rs:336-358``);
  3. runs every SpGEMM implementation under test (native C++ hash, Python
     linprobe hash, numpy ESC, device ESC);
  4. asserts CSR invariants always;
  5. when the problem is small enough to afford the naive oracle
     (``l*m*n < 2**15``, as the reference), checks the Higham (3.13) forward
     error bound rather than bitwise equality;
  6. on failure, dumps both inputs as MatrixMarket files for reproduction
     (``mul_hash.rs:41-45``).

Run: ``python -m sparse_matrix_tpu.verify.fuzz --cases 1000``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.accuracy import IsNanError, is_good_approx_of_mul
from ..core.dok import DokMatrix
from ..core.matrix_market import save_matrix_market
from ..formats.csr import CsrMatrix
from ..ops.spgemm_host import spgemm_esc_host, spgemm_hash_host

__all__ = ["fuzz_spgemm", "FuzzFailure"]

ORACLE_LIMIT = 2**15  # l*m*n budget for the naive oracle, as the reference


class FuzzFailure(AssertionError):
    pass


def _draw_dok(rng: np.random.Generator, rows: int, cols: int, non_finite: bool) -> DokMatrix:
    # entry budget of the libFuzzer generator the fuzz target uses:
    # min(1000, r*c + 5) random set_element ops
    # (spam_matrix/src/arbitrary.rs:7-21 via fuzz_targets/mul_hash.rs:20-25);
    # the unbounded 2*r*c budget belongs to the proptest DOK generator and
    # made 256-dim cases 15x slower for no extra coverage
    m = DokMatrix(rows, cols, dtype=np.float64)
    n_ops = int(rng.integers(0, min(1000, rows * cols + 5) + 1))
    near_sentinel = cols > (1 << 31)
    for _ in range(n_ops):
        i = int(rng.integers(0, rows))
        if near_sentinel and rng.random() < 0.5:
            # u32-sentinel edge: columns within 16 of cols-1 (up to
            # 2^32-2, one below the 0xFFFFFFFF empty sentinel) — the
            # discipline the reference's n in [1, 2^32-1] exercises
            # (fuzz/fuzz_targets/mul_hash.rs:15-19)
            j = int(cols - 1 - rng.integers(0, min(cols, 16)))
        else:
            j = int(rng.integers(0, cols))
        if non_finite and rng.random() < 0.02:
            t = rng.choice([np.nan, np.inf, -np.inf])
        else:
            t = rng.standard_normal() * 10.0 ** int(rng.integers(-3, 4))
        m.set_element((i, j), np.float64(t))
    return m


U64 = float(np.finfo(np.float64).eps) / 2.0
# the device path computes in f32 (jax x64 off); use the f32 epsilon (2x the
# f32 unit roundoff) so the bound also absorbs the f64->f32 input rounding
U32 = float(np.finfo(np.float32).eps)


# engines whose outputs carry int32 column lanes: gated out of the
# near-sentinel (cols ~ 2^32-1) envelope, a documented host capability
_INT32_COL_ENGINES = frozenset(
    {"esc_device", "fixed_side_lhs", "fixed_side_rhs", "esc_reduce_spmv"})


def _implementations(include_device: bool,
                     include_amortized: bool = False,
                     feats: Optional[dict] = None
                     ) -> List[Tuple[str, Callable, float]]:
    feats = feats if feats is not None else {}
    def hash_python_gated(a, b):
        # the python linprobe engine is the parity oracle for the table
        # semantics; it is O(products) pure python, so gate it by the same
        # work bound the naive oracle uses (fuzz_targets/mul_hash.rs:30)
        if a.rows * a.cols * b.cols < 2**15:
            return spgemm_hash_host(a, b, output_sorted=True, force_python=True)
        return None

    impls: List[Tuple[str, Callable, float]] = [
        ("hash_native", lambda a, b: spgemm_hash_host(a, b, output_sorted=False), U64),
        ("hash_python", hash_python_gated, U64),
        ("esc_numpy", spgemm_esc_host, U64),
    ]
    if include_device:
        from ..formats.device import DeviceCsr
        from ..ops.device_sorted import expand_plan, padded_to_host, spgemm_esc_device

        def esc_device(a, b):
            da, db = DeviceCsr.from_host(a), DeviceCsr.from_host(b)
            return padded_to_host(spgemm_esc_device(da, db, plan=expand_plan(a, b)))

        impls.append(("esc_device", esc_device, U32))
    if include_amortized:
        # the round-4 same-pattern engines (ops/spgemm_spmv.py). The
        # fixed-side engines are driven through their REFRESH contract:
        # plan on (a, b), then re-multiply with the varying side's values
        # scaled by 1.5 and unscale the result — so the fuzz exercises
        # the value-variance path while the Higham oracle still checks
        # against a @ b. (x*1.5 rounds when 3*mantissa needs >24 bits, so
        # the scale/unscale adds up to ~1 ulp of input perturbation —
        # absorbed by the bound's 2*gamma_n slack, NOT exact in binary;
        # ADVICE r4.)
        from ..ops.device_sorted import EscSpgemm
        from ..ops.spgemm_spmv import FixedSideSpgemm

        def _finite(a, b):
            # the SpMV-reduce engines promise exactness for FINITE streams
            # only (dense-window semantics otherwise — spgemm_spmv.py
            # contract; non-finite coverage belongs to the sort/hash
            # engines, which are exactly confined). Found by this very
            # fuzz: case167 leaked 0*inf=NaN through zero-weight window
            # slots before the contract (and the pad mask) existed.
            return bool(np.isfinite(a.vals).all() and np.isfinite(b.vals).all())

        def fixed_side(fixed):
            def run(a, b):
                if not _finite(a, b):
                    return None
                f = FixedSideSpgemm(a, b, fixed=fixed)
                # corpus-mode coverage signal: the selection operator's
                # dispatched format is a dispatch-path observation
                feats[f"fs_{fixed}"] = getattr(f.op, "format", None)
                vary = (b if fixed == "lhs" else a).vals.astype(np.float32)
                c = f.multiply(vary * np.float32(1.5))
                return CsrMatrix(c.rows, c.cols,
                                 np.asarray(c.vals) / np.float32(1.5),
                                 c.indices, c.offsets, is_sorted=True)
            return run

        def esc_reduce_spmv(a, b):
            if not _finite(a, b):
                return None
            e = EscSpgemm(a, b, reduce="spmv")
            if e._rspmv is None:  # expansion/reduction plan gated out
                return None
            feats["esc_rspmv"] = getattr(e._rspmv.op, "format", None)
            feats["esc_engine"] = getattr(e, "engine", None)
            return e.multiply()

        impls.append(("fixed_side_lhs", fixed_side("lhs"), U32))
        impls.append(("fixed_side_rhs", fixed_side("rhs"), U32))
        impls.append(("esc_reduce_spmv", esc_reduce_spmv, U32))
    return impls


def fuzz_spgemm(
    cases: int = 200,
    *,
    seed: int = 0,
    max_dim: int = 24,
    big_dim_prob: float = 0.05,
    wide_prob: float = 0.05,
    non_finite: bool = True,
    include_device: bool = False,
    include_amortized: bool = False,
    dump_dir: str = "fuzz_failures",
    corpus_dir: Optional[str] = None,
    mutate_prob: float = 0.5,
    verbose: bool = False,
) -> int:
    """Run the fuzz loop; returns the number of cases executed. Raises
    :class:`FuzzFailure` (after dumping inputs) on any violation.

    Envelope matches the reference's libFuzzer target
    (``fuzz/fuzz_targets/mul_hash.rs:15-19``): with probability
    ``big_dim_prob`` the dims are drawn up to 256 instead of ``max_dim``;
    with probability ``wide_prob`` the RHS column count is drawn near
    ``2^32 - 1`` (the u32-sentinel boundary — l and m stay bounded, as in
    the reference, because row counts size the offsets array).

    ``corpus_dir`` enables the corpus-guided mode (verify/corpus.py —
    the coverage-feedback analog of the reference's libFuzzer layer):
    cases whose dispatch-path signature is new are persisted, and with
    probability ``mutate_prob`` a case is drawn by mutating a stored one
    instead of sampling fresh."""
    rng = np.random.default_rng(seed)
    feats: dict = {}
    impls = _implementations(include_device, include_amortized, feats)
    corpus = None
    if corpus_dir is not None:
        from .corpus import FuzzCorpus, case_signature, mutate_pair

        corpus = FuzzCorpus(corpus_dir)
    new_sigs = 0
    for case in range(cases):
        a = b = None
        if corpus is not None and len(corpus) and rng.random() < mutate_prob:
            pair = corpus.sample(rng)
            if pair is not None:
                a, b = mutate_pair(rng, pair[0], pair[1], non_finite)
        if a is None:
            dim_cap = 256 if rng.random() < big_dim_prob else max_dim
            l = int(rng.integers(1, dim_cap + 1))
            m = int(rng.integers(1, dim_cap + 1))
            if rng.random() < wide_prob:
                # top 3 values end at 2^32-1 cols => max index 2^32-2, one
                # below the 0xFFFFFFFF empty sentinel
                n = int((1 << 32) - 1 - rng.integers(0, 3))
            else:
                n = int(rng.integers(1, dim_cap + 1))
            a = _draw_dok(rng, l, m, non_finite)
            b = _draw_dok(rng, m, n, non_finite)
        l, m, n = a.rows, a.cols, b.cols
        ca = CsrMatrix.from_dok_shuffled(a, rng)
        cb = CsrMatrix.from_dok_shuffled(b, rng)
        small = l * m * n < ORACLE_LIMIT
        feats.clear()
        ran = []
        for name, impl, u in impls:
            if name in _INT32_COL_ENGINES and n > (1 << 31) - 1:
                # device sorted ops carry columns in int32 lanes; the
                # near-sentinel column space is a documented host-side
                # capability (the kernels gate on cols, ops/spmv.py)
                continue
            c = impl(ca, cb)
            if c is None:  # engine gated out for this size
                continue
            ran.append(name)
            if not c.invariants():
                _dump(dump_dir, case, name, a, b)
                raise FuzzFailure(f"case {case}: {name} violated CSR invariants")
            if small:
                try:
                    good = is_good_approx_of_mul(c.to_dok(), a, b, u=u)
                except IsNanError:
                    continue  # NaN norms: bound undefined, as the reference
                if not good:
                    _dump(dump_dir, case, name, a, b)
                    raise FuzzFailure(
                        f"case {case}: {name} failed the Higham bound "
                        f"(inputs dumped to {dump_dir}/)"
                    )
        if corpus is not None:
            sig = case_signature(ca, cb, ran, feats)
            if corpus.maybe_add(sig, a, b):
                new_sigs += 1
        if verbose and case % 50 == 0:
            print(f"  case {case}/{cases}", file=sys.stderr)
    if corpus is not None and verbose:
        print(f"  corpus: {len(corpus)} signatures ({new_sigs} new)",
              file=sys.stderr)
    return cases


def _dump(dump_dir: str, case: int, name: str, a: DokMatrix, b: DokMatrix) -> None:
    os.makedirs(dump_dir, exist_ok=True)
    save_matrix_market(a, os.path.join(dump_dir, f"case{case}_{name}_lhs.mtx"))
    save_matrix_market(b, os.path.join(dump_dir, f"case{case}_{name}_rhs.mtx"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cases", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-dim", type=int, default=24)
    ap.add_argument("--big-dim-prob", type=float, default=0.05)
    ap.add_argument("--wide-prob", type=float, default=0.05)
    ap.add_argument("--finite-only", action="store_true")
    ap.add_argument("--device", action="store_true", help="include the device ESC path")
    ap.add_argument("--amortized", action="store_true",
                    help="include the same-pattern SpGEMM-as-SpMV engines")
    ap.add_argument("--corpus", default=None, metavar="DIR",
                    help="corpus-guided mode: persist dispatch-signature-"
                         "novel cases to DIR and mutate stored ones "
                         "(the libFuzzer coverage-feedback analog)")
    ap.add_argument("--mutate-prob", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true",
                    help="pin jax to the host CPU (the device engines touch "
                         "jax; without this they run on the default "
                         "accelerator)")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    n = fuzz_spgemm(
        args.cases,
        seed=args.seed,
        max_dim=args.max_dim,
        big_dim_prob=args.big_dim_prob,
        wide_prob=args.wide_prob,
        non_finite=not args.finite_only,
        include_device=args.device,
        include_amortized=args.amortized,
        corpus_dir=args.corpus,
        mutate_prob=args.mutate_prob,
        verbose=True,
    )
    print(f"fuzz: {n} cases OK in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
