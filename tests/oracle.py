"""Slow float64 NumPy oracles mirroring the reference equations literally.

Each function is a direct transcription of the cited reference math
(`/root/reference/conv_gp/...`), written with explicit Python loops so it can
be trusted independently of the JAX implementations under test.  (The
reference's own tests had a broken hand-rolled oracle — SURVEY.md §4 — so
correctness of these is itself covered by shape/value sanity checks.)
"""

import numpy as np
from scipy.linalg import cholesky as sp_cholesky, solve_triangular


def rbf_K(variance, lengthscales, X, X2=None):
    X = np.asarray(X, np.float64)
    X2 = X if X2 is None else np.asarray(X2, np.float64)
    ls = np.broadcast_to(np.asarray(lengthscales, np.float64), (X.shape[1],))
    Xl, X2l = X / ls, X2 / ls
    d2 = ((Xl[:, None, :] - X2l[None, :, :]) ** 2).sum(-1)
    return variance * np.exp(-0.5 * d2)


def arccosine_K(variance, weight_variances, bias_variance, order, X, X2=None):
    X = np.asarray(X, np.float64)
    X2 = X if X2 is None else np.asarray(X2, np.float64)
    w = np.broadcast_to(np.asarray(weight_variances, np.float64), (X.shape[1],))

    def wprod(A, B):
        return (w * A) @ B.T + bias_variance

    def J(theta):
        if order == 0:
            return np.pi - theta
        if order == 1:
            return np.sin(theta) + (np.pi - theta) * np.cos(theta)
        return 3 * np.sin(theta) * np.cos(theta) + \
            (np.pi - theta) * (1 + 2 * np.cos(theta) ** 2)

    dX = np.sqrt(np.diag(wprod(X, X)))
    dX2 = np.sqrt(np.diag(wprod(X2, X2)))
    cos_theta = wprod(X, X2) / dX[:, None] / dX2[None, :]
    eps = 1e-15
    theta = np.arccos(np.clip(eps + (1 - 2 * eps) * cos_theta, -1, 1))
    return variance / np.pi * J(theta) * \
        dX[:, None] ** order * dX2[None, :] ** order


def conditional(Kmn, Kmm, Knn, f, full_cov=False, q_sqrt=None, white=False):
    """Literal transcription of `conv_gp/conditionals.py:6-67`."""
    Kmn = np.asarray(Kmn, np.float64)   # [P, M, N]
    Kmm = np.asarray(Kmm, np.float64)   # [M, M]
    Knn = np.asarray(Knn, np.float64)   # [P, N] or [P, N, N]
    f = np.asarray(f, np.float64)       # [M, R]
    P, M, N = Kmn.shape
    R = f.shape[1]

    Lm = sp_cholesky(Kmm, lower=True)
    A = np.stack([solve_triangular(Lm, Kmn[p], lower=True) for p in range(P)])

    if full_cov:
        fvar = Knn - np.einsum('pmn,pmk->pnk', A, A)
        fvar = np.tile(fvar[None], (R, 1, 1, 1))
    else:
        fvar = Knn - (A ** 2).sum(axis=1)
        fvar = np.tile(fvar[None], (R, 1, 1))

    if not white:
        A = np.stack([solve_triangular(Lm.T, A[p], lower=False)
                      for p in range(P)])

    fmean = np.einsum('pmn,mr->npr', A, f)

    if q_sqrt is not None:
        L = np.tril(np.asarray(q_sqrt, np.float64))
        LTA = np.einsum('rms,pmn->rspn', L, A)
        if full_cov:
            fvar = fvar + np.einsum('rspn,rspk->rpnk', LTA, LTA)
        else:
            fvar = fvar + (LTA ** 2).sum(axis=1)
    return fmean, fvar


def gauss_kl(q_mu, q_sqrt, K=None):
    q_mu = np.asarray(q_mu, np.float64)
    q_sqrt = np.tril(np.asarray(q_sqrt, np.float64))
    M, R = q_mu.shape
    kl = 0.0
    for r in range(R):
        S = q_sqrt[r] @ q_sqrt[r].T
        m = q_mu[:, r]
        if K is None:
            Kinv_S = S
            mKm = m @ m
            logdet_K = 0.0
        else:
            Kinv_S = np.linalg.solve(K, S)
            mKm = m @ np.linalg.solve(K, m)
            logdet_K = np.linalg.slogdet(K)[1]
        logdet_S = 2 * np.sum(np.log(np.abs(np.diag(q_sqrt[r]))))
        kl += 0.5 * (np.trace(Kinv_S) + mKm - M - logdet_S + logdet_K)
    return kl


def extract_patches(images, filter_size, stride=1, dilation=1):
    """[N,H,W,C] -> [N,P,L], TF extract_image_patches ordering
    ((fh, fw, C) fastest-last), literal loops."""
    images = np.asarray(images, np.float64)
    N, H, W, C = images.shape
    span = (filter_size - 1) * dilation + 1
    Hout = (H - span) // stride + 1
    Wout = (W - span) // stride + 1
    L = filter_size * filter_size * C
    out = np.zeros((N, Hout * Wout, L))
    for n in range(N):
        p = 0
        for i in range(Hout):
            for j in range(Wout):
                patch = images[n,
                               i * stride:i * stride + span:dilation,
                               j * stride:j * stride + span:dilation, :]
                out[n, p] = patch.reshape(-1)  # row-major (fh, fw, C)
                p += 1
    return out


def prob_is_largest(Y, mu, var, num_classes, num_gh=20):
    """gpflow RobustMax.prob_is_largest, literal loops + numpy hermgauss."""
    from scipy.special import erf
    gh_x, gh_w = np.polynomial.hermite.hermgauss(num_gh)
    mu = np.asarray(mu, np.float64)
    var = np.asarray(var, np.float64)
    Y = np.asarray(Y).reshape(-1)
    N, K = mu.shape
    out = np.zeros(N)
    for n in range(N):
        c = int(Y[n])
        Xg = mu[n, c] + gh_x * np.sqrt(2.0 * var[n, c])
        prod = np.ones(num_gh)
        for j in range(K):
            if j == c:
                continue
            cdf = 0.5 * (1 + erf((Xg - mu[n, j]) / np.sqrt(var[n, j]) /
                                 np.sqrt(2.0)))
            cdf = cdf * (1 - 2e-4) + 1e-4
            prod = prod * cdf
        out[n] = np.sum(prod * gh_w) / np.sqrt(np.pi)
    return out


def multiclass_variational_expectations(Y, mu, var, num_classes, eps=1e-3):
    p = prob_is_largest(Y, mu, var, num_classes)
    return p * np.log(1 - eps) + (1 - p) * np.log(eps / (num_classes - 1))
