"""Convolutional (patch-space) kernels.

Rebuilds of:
* ``MultiOutputConvKernel`` (`conv_gp/layers.py:12-50`) — per-patch-position
  covariance blocks for hidden ConvLayers;
* ``ConvKernel`` (`conv_gp/kernels.py:79-137`) — weighted double patch sum,
  the default last-layer kernel (``--last-kernel conv``);
* ``AdditivePatchKernel`` (`conv_gp/kernels.py:15-77`) — weighted mean over
  per-patch kernels.  (The reference's ``K`` with ``X2=None`` had a latent
  NameError, SURVEY.md §2 row 3; fixed here.)

Every ``tf.map_fn`` over the patch axis becomes a batched/broadcast kernel
evaluation — one big matmul instead of P small ones.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.config import settings
from deepcgp_tpu.ops.linalg import add_jitter
from deepcgp_tpu.utils import struct


def native_patch_order_ok(base_kernel, view) -> bool:
    """True when the hot path may extract patches in the conv lowering's
    NATIVE within-patch order (C, fh, fw) instead of TF's (fh, fw, C).

    Legal whenever every [L]-indexed quantity the kernel math touches can be
    permuted consistently: patch-vs-patch grams and patch-vs-Z
    cross-covariances are exact under a shared column permutation (Z rides
    ``Z[:, view.native_perm]``; Kuu sees only Z so it needs none), which
    holds for distance/inner-product kernels with SCALAR per-dim parameters
    — RBF with a scalar lengthscale, ArcCosine with scalar weight
    variances.  FullView only: partial views hand their patches to the mean
    function (`conv_gp/views.py:116-117`), whose filters are TF-ordered.

    Why it exists: the conv-lowered extraction births the [N, P, L] tensor
    with L minor — the layout every consumer matmul wants — so the
    slice-form stack+reshape relayout copies never exist.  OFF by default;
    ``DEEPCGP_PATCH_ORDER=native`` turns it on (grad/ELBO equivalence
    verified at f64 reassociation level).
    """
    from deepcgp_tpu.models.base_kernels import RBF, ArcCosine
    from deepcgp_tpu.models.views import FullView
    if os.environ.get('DEEPCGP_PATCH_ORDER', 'tf') != 'native':
        return False
    if not isinstance(view, FullView):
        return False
    if isinstance(base_kernel, RBF):
        return jnp.ndim(base_kernel.raw_lengthscales) == 0
    if isinstance(base_kernel, ArcCosine):
        return jnp.ndim(base_kernel.raw_weight_variances) == 0
    return False


@struct.dataclass
class MultiOutputConvKernel:
    """Shared base kernel evaluated independently at each patch position.

    Stateless beyond the base kernel; ``patch_count`` is static geometry.
    """

    base_kernel: object
    patch_count: int = struct.field(pytree_node=False, default=0)

    def Kuu(self, Z: jax.Array) -> jax.Array:
        """[M, M] = K(Z) + jitter I (`conv_gp/layers.py:18-21`)."""
        return add_jitter(self.base_kernel.K(Z), settings.jitter)

    def Kuf_PNM(self, Z: jax.Array, PNL_patches: jax.Array) -> jax.Array:
        """[P, N, M]: the natural (and M-minor, layout-friendly) orientation
        the batched kernel evaluation produces."""
        return self.base_kernel.K(PNL_patches, Z[None])  # [P, N, M]

    def Kuf(self, Z: jax.Array, PNL_patches: jax.Array) -> jax.Array:
        """[P, M, N] (`conv_gp/layers.py:23-32`), batched over P."""
        return jnp.swapaxes(self.Kuf_PNM(Z, PNL_patches), -1, -2)

    def Kff(self, PNL_patches: jax.Array) -> jax.Array:
        """[P, N, N] (`conv_gp/layers.py:34-41`)."""
        return self.base_kernel.K(PNL_patches)

    def Kdiag(self, PNL_patches: jax.Array) -> jax.Array:
        """[P, N] (`conv_gp/layers.py:43-50`)."""
        return self.base_kernel.Kdiag(PNL_patches)


def _default_patch_weights(patch_count: int, patch_weights, dtype):
    if patch_weights is None or np.asarray(patch_weights).size != patch_count:
        patch_weights = np.ones(patch_count)
    return jnp.asarray(patch_weights, dtype=dtype)


@struct.dataclass
class AdditivePatchKernel:
    """K(x, x') = mean_i w_i k(x[i], x'[i]) (`conv_gp/kernels.py:15-77`).

    ``view`` is static geometry; inputs are flattened images [N, H*W*C].
    """

    base_kernel: object
    patch_weights: jax.Array  # [P]
    view: object = struct.field(pytree_node=False, default=None)

    @classmethod
    def create(cls, base_kernel, view, patch_weights=None, dtype=jnp.float32):
        return cls(base_kernel=base_kernel,
                   patch_weights=_default_patch_weights(
                       view.patch_count, patch_weights, dtype),
                   view=view)

    def _native_order(self) -> bool:
        return native_patch_order_ok(self.base_kernel, self.view)

    def _patches(self, ND_X: jax.Array) -> jax.Array:
        """[N, P, L] — NATIVE (C, fh, fw) element order whenever the kernel
        math permits (see :func:`native_patch_order_ok`), else TF order.
        Every in-class consumer is order-consistent: grams pair patches with
        patches, and cross-covariances pair them with
        :meth:`_Z_patch_order`-permuted inducing patches."""
        N = ND_X.shape[0]
        H, W = self.view.input_size
        NHWC = ND_X.reshape(N, H, W, self.view.feature_maps)
        if self._native_order():
            return self.view.extract_patches_NPL_native(NHWC)
        return self.view.extract_patches_NPL(NHWC)

    def _Z_patch_order(self, Z: jax.Array) -> jax.Array:
        """Z's columns in the order :meth:`_patches` produces.  Z is STORED
        in TF patch order (checkpoint/init/figure compatibility); the
        permutation is a [M, L] gather, invisible next to the matmuls it
        unlocks."""
        if self._native_order():
            return jnp.take(Z, jnp.asarray(self.view.native_perm), axis=1)
        return Z

    def _patches_any_order(self, ND_X: jax.Array) -> jax.Array:
        """[N, P, L] for consumers whose math only needs SOME fixed
        within-patch element order (pairwise distances/inner products among
        patches of one extraction) — i.e. the Kdiag gram.  Returns the same
        order as :meth:`_patches` so XLA shares the extraction with Kzx's."""
        return self._patches(ND_X)

    def K(self, ND_X: jax.Array, ND_X2: jax.Array | None = None) -> jax.Array:
        P1 = jnp.swapaxes(self._patches(ND_X), 0, 1)           # [P, N, L]
        if ND_X2 is None:
            # Keep the self-gram as X2=None so the base kernel uses its
            # exact-f32 gram path (the result can feed a sampling Cholesky).
            PNN = self.base_kernel.K(P1)                        # [P, N, N]
        else:
            P2 = jnp.swapaxes(self._patches(ND_X2), 0, 1)
            PNN = self.base_kernel.K(P1, P2)                    # [P, N, N2]
        PNN = PNN * self.patch_weights[:, None, None]
        return jnp.mean(PNN, axis=0)

    def Kdiag(self, ND_X: jax.Array,
              patches: jax.Array | None = None) -> jax.Array:
        from deepcgp_tpu.models.base_kernels import RBF
        if isinstance(self.base_kernel, RBF):
            # RBF Kdiag is the constant variance — patch values never enter
            # (mean_p w_p * v = v * mean(w)); skip the extraction.
            v = self.base_kernel.variance * jnp.mean(self.patch_weights)
            return jnp.full((ND_X.shape[0],), 1.0, ND_X.dtype) * v
        if patches is None:
            patches = self._patches(ND_X)
        P1 = jnp.swapaxes(patches, 0, 1)                        # [P, N, L]
        PN = self.base_kernel.Kdiag(P1)                          # [P, N]
        return jnp.mean(PN * self.patch_weights[:, None], axis=0)

    def _kdiag_needs_patches(self) -> bool:
        from deepcgp_tpu.models.base_kernels import RBF
        return not isinstance(self.base_kernel, RBF)

    def Kzx_NM_and_Kdiag(self, Z: jax.Array, ND_X: jax.Array) -> tuple:
        """(Kzx [N, M], Kdiag [N]) off ONE shared patch extraction — the
        per-step pair the last layer evaluates (`conv_gp/kernels.py:108-133`
        via `conv_gp/models.py:192-198`)."""
        from deepcgp_tpu.ops import conv_cross
        patches = None
        if (self._kdiag_needs_patches()
                or not conv_cross.supports(self.base_kernel, self.view)):
            patches = self._patches(ND_X)
        NPM = self._patch_kernel_NPM(ND_X, Z, patches=patches)
        return jnp.einsum('npm,p->nm', NPM, self._npm_weights()), \
            self.Kdiag(ND_X, patches)

    def _npm_weights(self) -> jax.Array:
        """patch_weights / P: the weighted patch mean of an [N, P, M]
        kernel matrix."""
        return self.patch_weights / self.patch_weights.shape[0]

    def _patch_kernel_NPM(self, ND_X: jax.Array, Z: jax.Array,
                          patches: jax.Array | None = None) -> jax.Array:
        """[N, P, M] = k(x[p], z_m) per patch position.  Scalar-RBF over a
        FullView can go through the conv formulation (ops/conv_cross.py,
        opt-in), where the im2col tensor never hits HBM.  ``patches`` (an
        extraction in :meth:`_patches` order) lets callers share ONE
        extraction across Kzx and Kdiag."""
        from deepcgp_tpu.ops import conv_cross
        if patches is None and conv_cross.supports(self.base_kernel,
                                                   self.view):
            N = ND_X.shape[0]
            H, W = self.view.input_size
            return conv_cross.rbf_cross_from_images(
                ND_X.reshape(N, H, W, self.view.feature_maps), Z,
                self.base_kernel.variance, self.base_kernel.lengthscales,
                self.view.filter_size, self.view.stride, self.view.dilation)
        if patches is None:
            patches = self._patches(ND_X)
        return self.base_kernel.K(patches, self._Z_patch_order(Z)[None])

    def Kzx_NM(self, Z: jax.Array, ND_X: jax.Array) -> jax.Array:
        """[N, M] = mean_p w_p k(x[p], Z) — M-minor orientation (matches the
        conditional's pnm layout; avoids retiling the [M, N*P] base-kernel
        matrix)."""
        NPM = self._patch_kernel_NPM(ND_X, Z)                    # [N, P, M]
        return jnp.einsum('npm,p->nm', NPM, self._npm_weights())

    def Kzx(self, Z: jax.Array, ND_X: jax.Array) -> jax.Array:
        return self.Kzx_NM(Z, ND_X).T

    def Kzz(self, Z: jax.Array) -> jax.Array:
        return self.base_kernel.K(Z)


@struct.dataclass
class ConvKernel(AdditivePatchKernel):
    """Weighted double patch sum (`conv_gp/kernels.py:79-137`):
    K(x, x') = sum_{ij} w_i w_j k(x[i], x'[j]) / P^2."""

    def K(self, ND_X: jax.Array, ND_X2: jax.Array | None = None) -> jax.Array:
        pc = self.view.patch_count
        L = self.view.patch_length
        p1 = self._patches(ND_X).reshape(-1, L)                 # [N*P, L]
        if ND_X2 is None:
            Kfull = self.base_kernel.K(p1)      # exact-f32 self-gram path
        else:
            Kfull = self.base_kernel.K(
                p1, self._patches(ND_X2).reshape(-1, L))
        N1 = ND_X.shape[0]
        N2 = N1 if ND_X2 is None else ND_X2.shape[0]
        Kfull = Kfull.reshape(N1, pc, N2, pc)
        w = self.patch_weights
        Kfull = Kfull * (w[None, :, None, None] * w[None, None, None, :])
        return jnp.sum(Kfull, axis=(1, 3)) / (pc ** 2)

    def Kdiag(self, ND_X: jax.Array,
              patches: jax.Array | None = None) -> jax.Array:
        pc = self.view.patch_count
        # Pairwise distances among one extraction's patches are invariant
        # to the within-patch element order -> any-order extraction is
        # safe.  Explicit X2: this gram is only weighted-summed into Kdiag
        # — never factorized — so it keeps the fast default-precision
        # matmul (the X2=None path requests exact-f32 for Cholesky-bound
        # grams).  (A stacked-slices einsum Gram that skips the im2col
        # measured 2.4x faster in ISOLATION but 6x slower inside the
        # S-vmapped step — XLA's lowering of the 6-D einsum under vmap is
        # pathological; benchmark inside the real program before swapping
        # this path.)
        if patches is None:
            patches = self._patches_any_order(ND_X)              # [N, P, L]
        NPP = self.base_kernel.K(patches, patches)               # [N, P, P]
        w = self.patch_weights
        W = w[:, None] * w[None, :]
        return jnp.sum(NPP * W, axis=(1, 2)) / (pc ** 2)

    def _kdiag_needs_patches(self) -> bool:
        return True

    # Kzx (= sum_p w_p k(z, x[p]) / P, `conv_gp/kernels.py:117-133`) is the
    # same contraction as AdditivePatchKernel's and is inherited from it in
    # the M-minor orientation.
