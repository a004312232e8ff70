"""Views: patch geometry + extraction, defining each conv layer's output size.

Rebuild of `conv_gp/views.py`.  Views are *static* (hashable, frozen)
configuration objects — they carry no learnable parameters (the reference
subclasses gpflow ``Parameterized`` but never adds params) — so they can be
closed over by jitted functions.

Internal layout note: the reference works patch-major ([P, N, L],
`conv_gp/views.py:40-44`); this rebuild prefers batch-major [N, P, L] (the
natural layout for one fused matmul over all patches) and transposes at
the few parity seams.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from deepcgp_tpu.ops.patches import extract_patches, out_size


@dataclasses.dataclass(frozen=True)
class FullView:
    """All patches of the image (reference `conv_gp/views.py:18-68`)."""

    input_size: tuple  # (H, W)
    filter_size: int
    feature_maps: int
    stride: int = 1
    dilation: int = 1

    @property
    def patch_shape(self):
        return (self.filter_size, self.filter_size)

    @property
    def patch_length(self) -> int:
        return self.feature_maps * self.filter_size * self.filter_size

    @property
    def out_image_height(self) -> int:
        return out_size(self.input_size[0], self.filter_size, self.stride,
                        self.dilation)

    @property
    def out_image_width(self) -> int:
        return out_size(self.input_size[1], self.filter_size, self.stride,
                        self.dilation)

    @property
    def patch_count(self) -> int:
        return self.out_image_height * self.out_image_width

    def extract_patches_NPL(self, NHWC_X: jax.Array) -> jax.Array:
        """[N, P, L]."""
        return extract_patches(NHWC_X, self.filter_size, self.stride,
                               self.dilation)

    def extract_patches_NPL_native(self, NHWC_X: jax.Array) -> jax.Array:
        """[N, P, L] in the conv lowering's native (C, fh, fw) element order
        — see :func:`deepcgp_tpu.ops.patches.extract_patches_native`.  Pair
        with :attr:`native_perm` on every [L]-indexed parameter."""
        from deepcgp_tpu.ops.patches import extract_patches_native
        return extract_patches_native(NHWC_X, self.filter_size, self.stride,
                                      self.dilation)

    @property
    def native_perm(self):
        """int32 [L]: ``native_patches[..., i] == tf_patches[..., perm[i]]``."""
        from deepcgp_tpu.ops.patches import native_perm
        return native_perm(self.filter_size, self.feature_maps)

    def extract_patches_PNL(self, NHWC_X: jax.Array) -> jax.Array:
        """Reference layout ([P, N, L], `conv_gp/views.py:40-44`)."""
        return jnp.swapaxes(self.extract_patches_NPL(NHWC_X), 0, 1)

    def mean_view(self, NHWC_X: jax.Array, NPL_patches: jax.Array) -> jax.Array:
        """Input handed to the mean function (`conv_gp/views.py:14-16`)."""
        return NHWC_X


@dataclasses.dataclass(frozen=True)
class RandomPartialView:
    """A fixed random subset of stride-1 patch positions
    (reference `conv_gp/views.py:70-117`) — the patch-axis analog of sparse
    attention; used to cap the P axis.

    ``patch_indices`` are flat indices into the full stride-1 patch grid,
    sorted by (y, x) like the reference's ordering sort
    (`conv_gp/views.py:104-114`).
    """

    input_size: tuple
    filter_size: int
    feature_maps: int
    patch_count: int
    patch_indices: tuple = None  # flat indices, filled by __post_init__
    seed: int = 0

    def __post_init__(self):
        if self.patch_indices is None:
            rng = np.random.RandomState(self.seed)
            H, W = self.input_size
            f = self.filter_size
            available = max(0, H - f) * max(0, W - f)
            if self.patch_count > available:
                raise ValueError(
                    f"patch_count={self.patch_count} exceeds the "
                    f"{available} distinct sampleable positions of a "
                    f"{H}x{W} image with filter {f} (the sampler draws "
                    "starts from [0, size - filter))")
            # Reference samples starts from arange(0, size - filter) —
            # excluding start == size - filter (`conv_gp/views.py:86-87`).
            taken = set()
            while len(taken) < self.patch_count:
                y = rng.choice(np.arange(0, H - f))
                x = rng.choice(np.arange(0, W - f))
                taken.add((int(y), int(x)))
            coords = sorted(taken)
            full_w = out_size(W, f, 1)
            flat = tuple(y * full_w + x for (y, x) in coords)
            object.__setattr__(self, 'patch_indices', flat)

    @property
    def stride(self) -> int:
        return 1

    @property
    def dilation(self) -> int:
        return 1

    @property
    def patch_shape(self):
        return (self.filter_size, self.filter_size)

    @property
    def patch_length(self) -> int:
        return self.feature_maps * self.filter_size * self.filter_size

    @property
    def out_image_height(self) -> int:
        return int(np.sqrt(self.patch_count))

    @property
    def out_image_width(self) -> int:
        return int(np.sqrt(self.patch_count))

    def extract_patches_NPL(self, NHWC_X: jax.Array) -> jax.Array:
        full = extract_patches(NHWC_X, self.filter_size, 1)  # [N, Pfull, L]
        idx = jnp.asarray(self.patch_indices, dtype=jnp.int32)
        return jnp.take(full, idx, axis=1)

    def extract_patches_PNL(self, NHWC_X: jax.Array) -> jax.Array:
        return jnp.swapaxes(self.extract_patches_NPL(NHWC_X), 0, 1)

    def mean_view(self, NHWC_X: jax.Array, NPL_patches: jax.Array) -> jax.Array:
        """Partial views pass the selected patches to the mean function
        (`conv_gp/views.py:116-117`)."""
        return NPL_patches
