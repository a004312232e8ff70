"""Analytic FLOP accounting for one optimizer step (SURVEY.md §3.3 cost
lines), and the peak rates MFU is quoted against.

Two counts, LLM-convention style:

* ``training_step_flops`` — **model FLOPs**: the algorithmic matmul-shaped
  work of the doubly-stochastic step (cross-covariances, triangular
  *solves*, Choleskys, the conditional's mean / q_sqrt einsums, the KL
  solves), with bwd = 2x fwd.  This is what MFU is quoted from, so the
  figure stays comparable across implementations (an implementation that
  does *extra* arithmetic — e.g. explicit factor inverses, rematerialized
  kernels — does not get MFU credit for it, exactly like activation
  recompute in LLM MFU accounting).
* ``training_step_hardware_flops`` — what the shipped implementation
  actually executes: the conditional / gauss_kl solves run as dense
  matmuls against precomputed factor inverses (``ops/linalg.chol_with_inv``),
  which is more arithmetic than a triangular solve.  This is the number to
  cross-check against XLA's ``compiled.cost_analysis()['flops']``
  (bench.py prints both).

Elementwise work (exp epilogues, reparameterisation, likelihood quadrature)
is bandwidth- not FLOP-bound and is deliberately excluded from both.
"""

from __future__ import annotations


def _conv_layer_flops(layer, N: int, hardware: bool):
    """(per-evaluation flops, once-per-step flops) for a hidden ConvLayer.

    Geometry: P patch positions, M inducing patches of dim L, R GPs per
    position, batch N (reference hot path `conv_gp/layers.py:96-135` +
    `conditionals.py:6-67`).
    """
    P = layer.patch_count
    M = layer.num_inducing
    R = layer.gp_count
    L = layer.Z.shape[1]
    solves = 1 if layer.white else 2
    grams = 1 if layer.white else 2    # Lm (+ frozen-Z0 KL prior Lp)
    # Triangular solve with k rhs ~ k*M^2 flops; the shipped inverse-form
    # runs it as a dense k x M x M matmul (2x the arithmetic).
    solve_cost = 2 * P * N * M * M if hardware else P * N * M * M
    per_eval = (
        2 * P * N * M * L              # Kuf cross-covariance matmul
        + solves * solve_cost          # whitening solve(s), P*N rhs
        + 2 * P * N * M * R            # fmean = A f
        + 2 * R * P * N * M * M        # q_sqrt variance term (A L per GP)
    )
    if hardware:
        per_step = (
            2 * M * M * L                      # Kuu
            + grams * (M ** 3 // 3 + M ** 3)   # chol + explicit L^-1 each
            + (0 if layer.white else (2 * R + 2) * M ** 3)
            # KL trace, inverse form: sum_r Lq Lq^T (2R M^3) + W=Lp^-T Lp^-1
        )
    else:
        per_step = (
            2 * M * M * L              # Kuu
            + M ** 3 // 3              # chol(Kuu)
            + (R + 1) * M ** 3         # KL: R M-rhs triangular solves + chol
        )
    return per_eval, per_step


def _svgp_layer_flops(layer, N: int, hardware: bool):
    """Same for the last SVGPLayer (patch-sum ConvKernel/AdditivePatchKernel
    or plain RBF; dispatch mirrors `conv_gp/kernels.py:172-178`)."""
    M = layer.num_inducing
    R = layer.num_outputs
    L = layer.Z.shape[1]
    P = layer.kernel.view.patch_count if hasattr(layer.kernel, 'view') else 1
    solves = 1 if layer.white else 2
    solve_cost = 2 * N * M * M if hardware else N * M * M
    per_eval = (
        2 * P * N * M * L          # Kzx (patch-summed when P > 1)
        + solves * solve_cost
        + 2 * N * M * R
        + 2 * R * N * M * M
    )
    if hardware:
        per_step = (
            2 * M * M * L
            + M ** 3 // 3 + M ** 3     # chol + explicit L^-1 (gram shared
                                       # between conditional and KL prior)
            + (0 if layer.white else (2 * R + 2) * M ** 3)
        )
    else:
        per_step = (
            2 * M * M * L
            + M ** 3 // 3
            + (R + 1) * M ** 3
        )
    return per_eval, per_step


def _step_flops(model, batch_size: int, hardware: bool) -> float:
    """The first layer's conditional is evaluated once and sampled S times
    (sample-independent input — models/dgp.py); every later layer runs S
    evaluations.  Backward pass modelled as 2x forward (fwd+bwd = 3x)."""
    S = model.num_samples
    total = 0.0
    for i, layer in enumerate(model.layers):
        if hasattr(layer, 'gp_count'):
            per_eval, per_step = _conv_layer_flops(layer, batch_size,
                                                   hardware)
        else:
            per_eval, per_step = _svgp_layer_flops(layer, batch_size,
                                                   hardware)
        evals = 1 if i == 0 else S
        total += evals * per_eval + per_step
    return 3.0 * total


def training_step_flops(model, batch_size: int) -> float:
    """Analytic *model* matmul FLOPs of ONE optimizer step (fwd + bwd).
    MFU is quoted from this figure — see the module docstring."""
    return _step_flops(model, batch_size, hardware=False)


def training_step_hardware_flops(model, batch_size: int) -> float:
    """Analytic matmul FLOPs the shipped inverse-form implementation actually
    executes per step — the comparator for XLA's cost analysis."""
    return _step_flops(model, batch_size, hardware=True)


def _tree_bytes(tree) -> int:
    import jax
    return sum(leaf.size * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(tree)
               if hasattr(leaf, 'size'))


def training_step_min_bytes(model, batch_size: int,
                            moment_bytes_per_param: int = 8) -> float:
    """Analytic MODEL-MINIMAL HBM bytes of ONE optimizer step — the bytes
    companion of :func:`training_step_flops`.

    Convention (the floor of floors — assumes perfect fusion, i.e. NO
    intermediate ever round-trips HBM; everything recomputable is
    recomputed on chip): per step the program must at minimum
      * read the minibatch rows once               (B * D * itemsize),
      * read every parameter twice (fwd + bwd — the LLM-convention
        weights-read accounting),
      * write every gradient once and read it once (optimizer input),
      * read + write the optimizer moments          (``moment_bytes_per_
        param`` = 8 for the two f32 Adam moments; the SR-bf16 storage
        halves it), each direction once,
      * write every updated parameter once.
    Everything else — kernel matrices, im2col tensors, conditional
    intermediates, MC samples — is implementation traffic: legitimate
    (often cheaper than recompute) but not part of the floor.
    """
    p_bytes = _tree_bytes(model)
    n_params = p_bytes / 4                       # f32 leaves
    # Minibatch row width: the first layer's input dimensionality.
    view = getattr(model.layers[0], 'view', None)
    if view is None:
        kern = getattr(model.layers[0], 'kernel', None)
        view = getattr(kern, 'view', None)
    if view is not None:
        H, W = view.input_size
        D = H * W * view.feature_maps
    else:
        D = int(model.layers[0].Z.shape[1])
    batch_read = batch_size * D * 4
    return float(batch_read
                 + 2 * p_bytes          # params read fwd + bwd
                 + 2 * p_bytes          # grads written + read
                 + 2 * n_params * moment_bytes_per_param  # moments r+w
                 + p_bytes)             # updated params written


# Published peaks per device, keyed by a substring of ``device_kind``
# (NVIDIA H100 SXM data sheet; dense rates, no sparsity; at the card's full
# 700 W power limit).  bench.py quotes MFU against ``tf32``: the hot
# cross-covariance matmuls are float32 at DEFAULT precision, which the H100
# runs on its TF32 tensor cores.
PEAKS = {
    'H100': {
        'bf16': 989e12,
        'tf32': 495e12,
        'fp32': 67e12,       # outside the tensor cores
        'fp64': 67e12,       # FP64 tensor cores
        'hbm_bytes_per_s': 3.35e12,
    },
}

# The peak that MFU is quoted against.
MFU_PEAK = 'tf32'


def device_peaks(device) -> dict:
    """The :data:`PEAKS` row of ``device``; a device missing from the table
    is an error, not a default."""
    kind = getattr(device, 'device_kind', '')
    for key, row in PEAKS.items():
        if key.lower() in kind.lower():
            return row
    raise ValueError(f"no peak rates known for device kind {kind!r}; "
                     f"add a row to deepcgp_tpu.utils.flops.PEAKS")


def device_peak_flops(device) -> float:
    """The :data:`MFU_PEAK` rate of ``device``, FLOP/s."""
    return device_peaks(device)[MFU_PEAK]
