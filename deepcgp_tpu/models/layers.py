"""GP layers: hidden convolutional SVGP layers and the final SVGP layer.

Rebuild of `conv_gp/layers.py:52-162` (ConvLayer) and of the external
``doubly_stochastic_dgp.layers.SVGP_Layer`` used as the last layer
(`conv_gp/models.py:192-198`; the submodule is empty in the reference mount,
so SVGPLayer here is implemented from the call-site contract and the
Salimbeni-Deisenroth formulation — SURVEY.md §2 external row).

Layers are immutable pytree dataclasses (utils/struct.py).  Each exposes:

* ``precompute()`` -> cache holding the Cholesky of Kuu.  The doubly-
  stochastic DGP re-enters a layer once per Monte-Carlo sample; Kuu depends
  only on (Z, kernel hyperparameters), so the Cholesky is computed once per
  step and shared across samples (the reference recomputes it per sample
  path — SURVEY.md §3.3).
* ``conditional_mean_var(cache, ND_X, full_cov)`` -> (mean [N, O], var).
* ``KL()`` -> scalar.
"""

from __future__ import annotations

import functools
import os
import typing

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.config import settings
from deepcgp_tpu.models.conv_kernels import MultiOutputConvKernel
from deepcgp_tpu.ops import linalg
from deepcgp_tpu.ops.conditional import multi_output_conditional
from deepcgp_tpu.parallel import sharding
from deepcgp_tpu.utils import struct


class LayerCache(typing.NamedTuple):
    Lm: jax.Array              # Cholesky of Kuu(Z), [M, M]
    # ConvLayer only: Cholesky of the frozen-Z0 KL prior Kuu (None when
    # white or when the cache was built outside DGP.precompute's batched
    # factorization).
    Lp: typing.Any = None
    # Explicit factor inverses (linalg.chol_with_inv): downstream solves
    # run as inverse-apply-precision matmuls with a matmul-only backward, in
    # place of TRSM/Cholesky-VJP custom-call chains.  None => solve path.
    Lm_inv: typing.Any = None
    Lp_inv: typing.Any = None


@functools.partial(jax.jit, static_argnames=('count', 'scale'))
def _init_qsqrt_conv(base_kernel, Z, count: int, scale: float) -> jax.Array:
    """q_sqrt init = scale * chol(Kuu(Z)) tiled ``count`` times.  Jitted at
    module level so model construction runs one compiled (and persistently
    cached) program per shape instead of a chain of eager dispatches."""
    kern = MultiOutputConvKernel(base_kernel=base_kernel, patch_count=1)
    Lu = linalg.cholesky(kern.Kuu(Z))
    M = Z.shape[0]
    return jnp.broadcast_to(Lu[None], (count, M, M)) * scale


@functools.partial(jax.jit, static_argnames=('count',))
def _init_qsqrt_svgp(layer, Z, count: int) -> jax.Array:
    Lu = linalg.cholesky(layer._Kuu(Z))
    M = Z.shape[0]
    return jnp.broadcast_to(Lu[None], (count, M, M))


@struct.dataclass
class ConvLayer:
    """Hidden DGP layer: ``gp_count`` independent GPs shared across the P
    patch positions; ``num_outputs = P * gp_count``
    (`conv_gp/layers.py:52-94`)."""

    base_kernel: object          # RBF / ArcCosine over patch space
    Z: jax.Array                 # [M, L] inducing patches
    q_mu: jax.Array              # [M, R]
    q_sqrt: jax.Array            # [R, M, M] (lower triangle used)
    Z0: jax.Array                # frozen Z snapshot for the KL prior
    mean_function: object        # Zero / Conv2dMean / PatchwiseConv2d
    view: object = struct.field(pytree_node=False, default=None)
    white: bool = struct.field(pytree_node=False, default=False)
    gp_count: int = struct.field(pytree_node=False, default=1)

    # -- static geometry ----------------------------------------------------
    @property
    def patch_count(self) -> int:
        return self.view.patch_count

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def num_outputs(self) -> int:
        return self.view.patch_count * self.gp_count

    @property
    def conv_kernel(self) -> MultiOutputConvKernel:
        return MultiOutputConvKernel(base_kernel=self.base_kernel,
                                     patch_count=self.view.patch_count)

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, base_kernel, view, Z, *, mean_function, white=False,
               gp_count=1, q_mu=None, q_sqrt=None, q_sqrt_scale=1.0,
               dtype=jnp.float32) -> "ConvLayer":
        """Initial variational params follow `conv_gp/layers.py:80-91,154-161`:
        q_mu = 0; q_sqrt = chol(Kuu(Z)) tiled over gp_count (identity when
        whitened).  ``q_sqrt_scale`` implements the builder's fresh-start
        1e-5 scaling (`conv_gp/models.py:136-138`)."""
        Z = jnp.asarray(Z, dtype=dtype)
        M = Z.shape[0]
        if q_mu is None:
            q_mu = np.zeros((M, gp_count))
        q_mu = jnp.asarray(q_mu, dtype=dtype)
        if q_sqrt is None:
            if white:
                q_sqrt = np.broadcast_to(
                    np.eye(M) * q_sqrt_scale,
                    (gp_count, M, M)).astype(dtype)
                q_sqrt = jnp.asarray(q_sqrt)
            else:
                q_sqrt = _init_qsqrt_conv(base_kernel, Z, gp_count,
                                          float(q_sqrt_scale))
        else:
            q_sqrt = jnp.asarray(q_sqrt, dtype=dtype)
            if q_sqrt.ndim == 2:  # packed lower-tri checkpoint format
                from deepcgp_tpu.utils.transforms import \
                    lower_triangular_unflatten
                q_sqrt = lower_triangular_unflatten(q_sqrt, M)
        return cls(base_kernel=base_kernel, Z=Z, q_mu=q_mu, q_sqrt=q_sqrt,
                   Z0=Z, mean_function=mean_function, view=view, white=white,
                   gp_count=gp_count)

    # -- compute --------------------------------------------------------------
    def kuu_grams(self) -> tuple:
        """The [M, M] grams this layer needs factorized each step: Kuu(Z)
        for the conditional, plus the frozen-Z0 KL prior when non-white.
        DGP.precompute stacks same-shape grams across the whole stack into
        ONE batched Cholesky custom call (they are latency-bound — count
        calls, not FLOPs)."""
        if self.white:
            return (self.conv_kernel.Kuu(self.Z),)
        return (self.conv_kernel.Kuu(self.Z),
                self.conv_kernel.Kuu(jax.lax.stop_gradient(self.Z0)))

    def make_cache(self, pairs: tuple) -> LayerCache:
        """``pairs``: one (L, L^-1) per gram from :meth:`kuu_grams`, as
        produced by ``linalg.chol_with_inv`` (DGP.precompute batches the
        factorizations across the stack)."""
        Lm, Lm_inv = pairs[0]
        if self.white:
            return LayerCache(Lm=Lm, Lm_inv=Lm_inv)
        Lp, Lp_inv = pairs[1]
        return LayerCache(Lm=Lm, Lp=Lp, Lm_inv=Lm_inv, Lp_inv=Lp_inv)

    def precompute(self) -> LayerCache:
        return self.make_cache(tuple(linalg.chol_with_inv(g)
                                     for g in self.kuu_grams()))

    def conditional_mean_var(self, cache: LayerCache, ND_X: jax.Array,
                             full_cov: bool = False):
        """Rebuild of `conv_gp/layers.py:96-135`; returns
        (mean [N, P*R], var [N, P*R] or [N, N, P*R])."""
        from deepcgp_tpu.ops import conv_cross

        N = ND_X.shape[0]
        H, W = self.view.input_size
        NHWC_X = ND_X.reshape(N, H, W, self.view.feature_maps)

        if not full_cov and conv_cross.supports(self.base_kernel, self.view):
            # Scalar-RBF over a FullView: Kuf comes straight off the image
            # as a convolution with Z as filters (ops/conv_cross.py) — the
            # [P, N, L] im2col tensor never exists.  RBF Kdiag is the
            # constant variance and FullView.mean_view ignores the patches,
            # so nothing else needed them.
            NPM = conv_cross.rbf_cross_from_images(
                NHWC_X, self.Z, self.base_kernel.variance,
                self.base_kernel.lengthscales, self.view.filter_size,
                self.view.stride, self.view.dilation)
            Kuf = jnp.swapaxes(NPM, 0, 1)                # [P, N, M]
            Kuf = sharding.constrain(Kuf, 'model', 'data', None)
            Knn = jnp.broadcast_to(
                self.base_kernel.variance.astype(Kuf.dtype),
                (self.patch_count, N))                   # RBF Kdiag
            NPL = None
        else:
            from deepcgp_tpu.models.conv_kernels import native_patch_order_ok
            if native_patch_order_ok(self.base_kernel, self.view):
                # Conv-lowered extraction in the native (C, fh, fw) element
                # order: the [N, P, L] tensor is born L-minor (the Kuf/Kff
                # matmul layout), killing the slice-form stack+reshape
                # relayouts; Z rides the matching column permutation.  The
                # within-patch order is invisible to the distance math —
                # see native_patch_order_ok.
                NPL = self.view.extract_patches_NPL_native(NHWC_X)
                Zk = jnp.take(self.Z, jnp.asarray(self.view.native_perm),
                              axis=1)
            else:
                NPL = self.view.extract_patches_NPL(NHWC_X)
                Zk = self.Z
            PNL = jnp.swapaxes(NPL, 0, 1)
            # Under an active mesh: batch -> 'data', patch axis -> 'model'
            # (no-ops single-device; see deepcgp_tpu.parallel.sharding).
            PNL = sharding.constrain(PNL, 'model', 'data', None)

            Kuf = self.conv_kernel.Kuf_PNM(Zk, PNL)          # [P, N, M]
            Kuf = sharding.constrain(Kuf, 'model', 'data', None)
            if full_cov:
                Knn = self.conv_kernel.Kff(PNL)              # [P, N, N]
            else:
                Knn = self.conv_kernel.Kdiag(PNL)            # [P, N]

        mean, var = multi_output_conditional(
            Kuf, None, Knn, self.q_mu, full_cov=full_cov,
            q_sqrt=self.q_sqrt, white=self.white, Lm=cache.Lm,
            Lm_inv=cache.Lm_inv, layout='pnm')

        if full_cov:
            var = jnp.transpose(var, (2, 3, 1, 0)).reshape(
                N, N, self.num_outputs)
        else:
            var = jnp.transpose(var, (2, 1, 0)).reshape(N, self.num_outputs)
        mean = mean.reshape(N, self.num_outputs)

        mean_view = self.view.mean_view(NHWC_X, NPL)
        mean = mean + self.mean_function(mean_view)
        return mean, var

    def sample_from_conditional(self, ND_X: jax.Array, key: jax.Array,
                                full_cov: bool = False):
        """Reparameterised sample from q(f | X): (sample, mean, var) — the
        external Layer API used at `conv_gp/utils/tensorboard.py:73-74`."""
        return _sample_from_conditional(self, ND_X, key, full_cov)

    def KL(self, cache: LayerCache | None = None) -> jax.Array:
        """KL[q(u) || p(u)].  Non-white prior Kuu is built from the *frozen*
        Z snapshot — NOT the current Z — so ``cache.Lm`` cannot stand in for
        the prior (gradients flow through kernel hyperparameters but not Z
        — reference `conv_gp/layers.py:149-152`, SURVEY.md §2).  The prior's
        own Cholesky ``cache.Lp`` (same matrix, factorized in the batched
        per-step pass) is reused when present."""
        if self.white:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, None)
        if cache is not None and cache.Lp is not None:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, Lp=cache.Lp,
                                   Lp_inv=cache.Lp_inv)
        Kp = self.conv_kernel.Kuu(jax.lax.stop_gradient(self.Z0))
        return linalg.gauss_kl(self.q_mu, self.q_sqrt, Kp)


def _sample_from_conditional(layer, ND_X, key, full_cov: bool):
    from deepcgp_tpu.config import settings
    from deepcgp_tpu.models.dgp import mc_normal
    cache = layer.precompute()
    mean, var = layer.conditional_mean_var(cache, ND_X, full_cov=full_cov)
    if full_cov:
        # var [N, N, O]: correlated sample per output via Cholesky in N.
        N = mean.shape[0]
        cov = jnp.moveaxis(var, -1, 0)                       # [O, N, N]
        L = linalg.cholesky(cov + settings.jitter
                            * jnp.eye(N, dtype=mean.dtype))
        z = mc_normal(key, (mean.shape[1], N), mean.dtype)
        sample = mean + jnp.einsum('onk,ok->no', L, z)
    else:
        z = mc_normal(key, mean.shape, mean.dtype)
        sample = mean + z * jnp.sqrt(var + settings.jitter)
    return sample, mean, var


def _svgp_kuf_kdiag(kernel, Z, ND_X):
    """Kuf [N, M] + Kdiag [N] of the last layer, as one remat unit (see
    SVGPLayer.conditional_mean_var for the rationale).  The patch-sum
    kernels compute both off ONE shared extraction (Kzx_NM_and_Kdiag)."""
    if hasattr(kernel, 'Kzx_NM_and_Kdiag'):
        return kernel.Kzx_NM_and_Kdiag(Z, ND_X)
    if hasattr(kernel, 'Kzx_NM'):
        Kuf = kernel.Kzx_NM(Z, ND_X)
    else:
        Kuf = kernel.K(ND_X, Z)
    return Kuf, kernel.Kdiag(ND_X)


@struct.dataclass
class SVGPLayer:
    """Final SVGP layer over the whole (flattened) image with a single
    kernel shared across ``num_outputs`` latent GPs
    (contract of ``SVGP_Layer`` at `conv_gp/models.py:192-198`).

    ``kernel`` is either a patch-sum kernel exposing Kzz/Kzx/Kdiag
    (ConvKernel/AdditivePatchKernel with PatchInducingFeatures — dispatch at
    `conv_gp/kernels.py:172-178`) or a plain base kernel (RBF with
    InducingPoints, `conv_gp/models.py:160-168`)."""

    kernel: object
    Z: jax.Array                  # [M, D_feature]
    q_mu: jax.Array               # [M, R]
    q_sqrt: jax.Array             # [R, M, M]
    mean_function: object
    white: bool = struct.field(pytree_node=False, default=False)
    num_outputs_static: int = struct.field(pytree_node=False, default=10)

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def num_outputs(self) -> int:
        return self.num_outputs_static

    def _Kuu(self, Z) -> jax.Array:
        if hasattr(self.kernel, 'Kzz'):
            return linalg.add_jitter(self.kernel.Kzz(Z), settings.jitter)
        return linalg.add_jitter(self.kernel.K(Z), settings.jitter)

    def _Kuf_NM(self, ND_X) -> jax.Array:
        """[N, M] cross-covariance (M-minor, the conditional's layout —
        do NOT reintroduce an [M, N]-major variant; retiling that matrix
        was the dominant copy at M=1024)."""
        if hasattr(self.kernel, 'Kzx_NM'):
            return self.kernel.Kzx_NM(self.Z, ND_X)
        return self.kernel.K(ND_X, self.Z)

    @classmethod
    def create(cls, kernel, Z, *, num_outputs=10, mean_function=None,
               white=False, q_mu=None, q_sqrt=None,
               dtype=jnp.float32) -> "SVGPLayer":
        from deepcgp_tpu.models.mean_functions import Zero
        Z = jnp.asarray(Z, dtype=dtype)
        M = Z.shape[0]
        if mean_function is None:
            mean_function = Zero(output_dim=num_outputs)
        if q_mu is None:
            q_mu = np.zeros((M, num_outputs))
        q_mu = jnp.asarray(q_mu, dtype=dtype)
        if q_sqrt is None:
            if white:
                q_sqrt = jnp.asarray(np.broadcast_to(
                    np.eye(M), (num_outputs, M, M)).astype(dtype))
            else:
                layer = cls(kernel=kernel, Z=Z, q_mu=q_mu,
                            q_sqrt=jnp.zeros((num_outputs, M, M), dtype),
                            mean_function=mean_function, white=white,
                            num_outputs_static=num_outputs)
                q_sqrt = _init_qsqrt_svgp(layer, Z, num_outputs)
        else:
            q_sqrt = jnp.asarray(q_sqrt, dtype=dtype)
            if q_sqrt.ndim == 2:
                from deepcgp_tpu.utils.transforms import \
                    lower_triangular_unflatten
                q_sqrt = lower_triangular_unflatten(q_sqrt, M)
        return cls(kernel=kernel, Z=Z, q_mu=q_mu, q_sqrt=q_sqrt,
                   mean_function=mean_function, white=white,
                   num_outputs_static=num_outputs)

    def kuu_grams(self) -> tuple:
        """See ConvLayer.kuu_grams; the SVGP prior uses the CURRENT Z, so
        its conditional Cholesky doubles as the KL prior factor."""
        return (self._Kuu(self.Z),)

    def make_cache(self, pairs: tuple) -> LayerCache:
        Lm, Lm_inv = pairs[0]
        return LayerCache(Lm=Lm, Lm_inv=Lm_inv)

    def precompute(self) -> LayerCache:
        return self.make_cache((linalg.chol_with_inv(self._Kuu(self.Z)),))

    def conditional_mean_var(self, cache: LayerCache, ND_X: jax.Array,
                             full_cov: bool = False):
        N = ND_X.shape[0]
        if full_cov:
            Kuf = self._Kuf_NM(ND_X)[None]               # [1, N, M]
            Knn = self.kernel.K(ND_X)[None]              # [1, N, N]
        else:
            # Rematerialize the cross-covariance block in the backward:
            # without the checkpoint, XLA saves the [N, P, L] im2col tensor
            # and the [N, P, M] kernel matrix as residuals, and the backward
            # re-reads them through a chain of layout copies.  Recomputing
            # patches (static slices) + the distance matmuls in the backward
            # replaces the HBM round trip of ~29MB/step of residuals at the
            # flagship shape; only (ND_X, Z, hyperparams) is saved.
            # DEEPCGP_REMAT_NO_CSE_BARRIER=1 drops the optimization-
            # barrier custom-calls the checkpoint inserts — at the risk of
            # XLA CSE merging the recomputation back with the forward and
            # resurrecting the residuals this remat exists to avoid.
            prevent_cse = os.environ.get(
                'DEEPCGP_REMAT_NO_CSE_BARRIER', '0') != '1'
            Kuf, Knn = jax.checkpoint(_svgp_kuf_kdiag,
                                      prevent_cse=prevent_cse)(
                self.kernel, self.Z, ND_X)
            Kuf, Knn = Kuf[None], Knn[None]              # [1, N, M], [1, N]
        mean, var = multi_output_conditional(
            Kuf, None, Knn, self.q_mu, full_cov=full_cov,
            q_sqrt=self.q_sqrt, white=self.white, Lm=cache.Lm,
            Lm_inv=cache.Lm_inv, layout='pnm')
        if full_cov:
            var = jnp.transpose(var[:, 0], (1, 2, 0))    # [N, N, R]
        else:
            var = var[:, 0].T                            # [N, R]
        mean = mean[:, 0, :] + self.mean_function(ND_X)  # [N, R]
        return mean, var

    def sample_from_conditional(self, ND_X: jax.Array, key: jax.Array,
                                full_cov: bool = False):
        """See ConvLayer.sample_from_conditional."""
        return _sample_from_conditional(self, ND_X, key, full_cov)

    def KL(self, cache: LayerCache | None = None) -> jax.Array:
        """Unlike ConvLayer, the prior Kuu here uses the *current* Z (the
        external SVGP_Layer builds its prior Cholesky inside the graph, so Z
        receives KL gradients).  ``cache`` reuses the per-step Cholesky of
        Kuu(Z) — the same matrix — instead of refactorizing."""
        if self.white:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, None)
        if cache is not None:
            return linalg.gauss_kl(self.q_mu, self.q_sqrt, Lp=cache.Lm,
                                   Lp_inv=cache.Lm_inv)
        return linalg.gauss_kl(self.q_mu, self.q_sqrt, self._Kuu(self.Z))
