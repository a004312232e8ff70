"""Multi-output sparse variational GP conditional.

JAX rewrite of `conv_gp/conditionals.py:6-67`: the posterior
q(g1) = \\int q(g2) p(g1|g2) shared across P patch positions, where
p(g2) = N(0, Kmm), q(g2) = N(f, q_sqrt q_sqrt^T).

Differences from the reference (semantics identical, schedule reworked):

* the per-patch ``tf.map_fn`` triangular solves
  (`conv_gp/conditionals.py:31-33,44-47`) become one wide solve with
  P*N right-hand sides;
* the q_sqrt term (`conv_gp/conditionals.py:53-65`) is a single einsum;
* the Cholesky of Kmm can be passed in precomputed (``Lm``) so a layer can
  share it across the S Monte-Carlo samples of the doubly-stochastic DGP
  (the reference recomputes it per sample path, §3.3 of SURVEY.md).

Shapes (P = patch positions, M = inducing, N = batch, R = GPs per position):
  Kmn: [P, M, N];  Kmm: [M, M];  Knn: [P, N] (diag) or [P, N, N] (full);
  f: [M, R];  q_sqrt: [R, M, M] lower-triangular.
Returns (fmean [N, P, R], fvar [R, P, N] or [R, P, N, N]) exactly like the
reference's return layout (`conv_gp/conditionals.py:67`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from deepcgp_tpu.ops import linalg


def multi_output_conditional(
    Kmn: jax.Array,
    Kmm: jax.Array | None,
    Knn: jax.Array,
    f: jax.Array,
    *,
    full_cov: bool = False,
    q_sqrt: jax.Array | None = None,
    white: bool = False,
    Lm: jax.Array | None = None,
    Lm_inv: jax.Array | None = None,
    layout: str = 'pmn',
):
    """``layout``: 'pmn' takes Kmn as [P, M, N] (the reference layout);
    'pnm' takes [P, N, M].  Internally everything runs M-minor ('pnm'):
    M is large in practice while N is a small batch, so keeping M
    innermost avoids the layout-change copies that otherwise dominate the
    step."""
    if layout == 'pmn':
        Kmn = jnp.swapaxes(Kmn, -1, -2)                      # -> [P, N, M]
    if Lm is None:
        Lm = linalg.cholesky(Kmm)

    R = f.shape[1]
    HI = linalg._INV_PRECISION

    # Row form of A = Lm^-1 Kmn per patch, M-minor (fold [P, N, M] ->
    # [P*N, M]; the fold is layout-free since M is already innermost).
    # With a precomputed factor inverse (linalg.chol_with_inv) the solve
    # is ONE matmul at the inverse-apply precision
    # (linalg._INV_PRECISION, gate-validated vs the TRSM custom call it
    # replaces) — no InvertDiagBlocks / block-panel latency, and a
    # backward that is again a matmul instead of another custom-call
    # solve chain.
    shape = Kmn.shape
    if Lm_inv is not None:
        A = jnp.einsum('pnm,sm->pns', Kmn, Lm_inv, precision=HI)
    else:
        A = lax.linalg.triangular_solve(
            Lm, Kmn.reshape(-1, shape[-1]), left_side=False,
            lower=True, transpose_a=True).reshape(shape)

    if full_cov:
        # fvar[p] = Knn[p] - A[p] A[p]^T  (row form).
        fvar = Knn - jnp.einsum('pnm,pkm->pnk', A, A)        # [P, N, N]
        fvar = jnp.broadcast_to(fvar[None], (R,) + fvar.shape)  # [R, P, N, N]
    else:
        fvar = Knn - jnp.sum(jnp.square(A), axis=-1)         # [P, N]
        fvar = jnp.broadcast_to(fvar[None], (R,) + fvar.shape)  # [R, P, N]

    if not white:
        # Unwhitened: A <- A Lm^-1 (row form of Lm^-T A,
        # reference conditionals.py:44-47).
        if Lm_inv is not None:
            A = jnp.einsum('pnm,mk->pnk', A, Lm_inv, precision=HI)
        else:
            shape = A.shape
            A = lax.linalg.triangular_solve(
                Lm, A.reshape(-1, shape[-1]), left_side=False,
                lower=True).reshape(shape)

    # fmean = A f -> [N, P, R].
    fmean = jnp.einsum('pnm,mr->npr', A, f)

    if q_sqrt is not None:
        L = jnp.tril(q_sqrt)                                  # [R, M, M]
        if full_cov:
            # Eval/sampling path (small N): the batched form is fine here.
            LTA = jnp.einsum('rms,pnm->rpns', L, A)           # [R, P, N, M]
            fvar = fvar + jnp.einsum('rpns,rpks->rpnk', LTA, LTA)
        else:
            # q-term[r] = rowwise ||A L_r||^2 (the LTA term of
            # conditionals.py:53-65), computed as ONE wide matmul
            # [P*N, M] @ [M, R*M] with the square-reduce fused onto its
            # M-minor output.  The batched-einsum form ('rms,pnm->rpns')
            # broadcasts A across the R batch dimension and stacks the
            # result R-major, with layout copies around that [R, P, N, M]
            # intermediate; a scan over R starves the matmul units
            # instead.  The wide form reads A once,
            # writes LTA once in its native layout, and the reduce is
            # over the minor axis.
            P, N, M = A.shape
            LTA = jnp.einsum('xm,rms->xrs', A.reshape(P * N, M),
                             L)                               # [P*N, R, M]
            # Under a mesh, the R (GP/output) axis is the model-parallel
            # axis of the [*, R, M]/[R, M, M] variational work — the
            # M=1024 config's heavy stacks are all R-batched, while the
            # [M, M] factorization itself is serial and stays replicated
            # (SURVEY §2.10 M-sharding, pinned by dryrun_multichip).
            # Constrain ONLY the SVGP case (P == 1), where dim 0 is
            # unambiguously the data-sharded batch: a None spec entry is
            # a hard replicate pin, so constraining here with P > 1
            # (dim 0 = flattened P*N, P 'model'-sharded in-layer) would
            # force an all-gather of A over 'data' and duplicate the
            # dominant q-term matmul on every chip.  ConvLayer LTA is
            # left to GSPMD propagation from the in-layer constraints.
            if P == 1:
                from deepcgp_tpu.parallel import sharding
                LTA = sharding.constrain(LTA, 'data', 'model', None)
            qterm = jnp.sum(jnp.square(LTA), axis=-1)         # [P*N, R]
            fvar = fvar + jnp.transpose(
                qterm.reshape(P, N, -1), (2, 0, 1))           # [R, P, N]

    if not full_cov:
        # f32 guard: with an ill-conditioned Kmm (near-duplicate
        # inducing patches — e.g. k-means centroids on the coarse UCI
        # digits set), the inverse-apply matmul noise scales like
        # ||Lm_inv||^2 * eps * Knn and can exceed a small true posterior
        # variance, pushing the Knn - ||A||^2 diagonal negative (observed
        # -5e-3 against the +9e-4 exact value on the digits 2-layer config
        # with reduced-precision inverse applies, which then NaN'd
        # sqrt(var) in sampling from step one).
        # The diagonal is a marginal variance, >= 0 by definition and
        # exactly 0 at an inducing input in the noiseless limit, so 0 is
        # the numerically-correct clamp, not a fudge; the q_sqrt term
        # added above is a sum of squares and cannot un-negate it.
        # The reference never needed this only because gpflow runs f64
        # (`conv_gp/conditionals.py:40-42` subtracts unprotected).
        fvar = jnp.maximum(fvar, 0.0)
    else:
        # Mirror of the diag clamp for the full-cov path: the SAME f32
        # noise sits on the diagonal of the [N, N] downdate
        # (`conv_gp/conditionals.py:36-41` under f64 never sees it), and
        # sample_from_conditional(full_cov=True) Choleskys this matrix —
        # a negative diagonal NaNs it beyond what the sampling jitter can
        # absorb.  Marginal variances are >= 0 by definition, so floor the
        # diagonal at 0 (subtract its negative part; off-diagonals and
        # healthy entries untouched).  Eval/sampling path only — cost is
        # irrelevant, so the scatter-add backward of jnp.diagonal is fine.
        diag = jnp.diagonal(fvar, axis1=-2, axis2=-1)        # [R, P, N]
        eye = jnp.eye(fvar.shape[-1], dtype=fvar.dtype)
        fvar = fvar - jnp.minimum(diag, 0.0)[..., None] * eye

    return fmean, fvar
