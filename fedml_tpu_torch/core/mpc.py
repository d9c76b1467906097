"""Finite-field MPC primitives for secure aggregation (port of
fedml_tpu/core/mpc.py, which is numpy only; the port keeps its own copy,
bitwise equal).

Parity: fedml_api/distributed/turboaggregate/mpc_function.py — BGW secret
sharing (:62-108), Lagrange Coded Computing encode/decode (:111-260),
additive shares (:214-224), and DH-style key agreement (:263-275).

These are *control-plane* host ops on small integers; they stay numpy
(int64 + Python-int modular inverses): the model math runs on the device
and enters/leaves this layer through fixed-point quantization
(`quantize`/`dequantize`).
"""
from __future__ import annotations

import numpy as np

# A 31-bit prime (reference uses p = 2^31 - 1 style fields); int64 products
# of two <p residues overflow, so reduce via Python ints / object math where
# needed. 2147483647 = 2^31 - 1 (Mersenne).
DEFAULT_PRIME = 2_147_483_647


def _mod(a: np.ndarray, p: int) -> np.ndarray:
    return np.mod(a, p)


def modinv(a: int, p: int) -> int:
    return pow(int(a), p - 2, p)


def modmat(A: np.ndarray, B: np.ndarray, p: int) -> np.ndarray:
    """Modular matrix product with object-int accumulation (no overflow)."""
    A = A.astype(object)
    B = B.astype(object)
    return np.mod(A @ B, p).astype(np.int64)


# -- fixed-point bridge ------------------------------------------------------

def quantize(x: np.ndarray, scale: int = 2 ** 16,
             p: int = DEFAULT_PRIME,
             max_abs: int | None = None) -> np.ndarray:
    """float → field: round(x·scale) mod p, negatives wrap to [p/2, p).

    Non-finite inputs are rejected FIRST: inf/NaN cast to INT64_MIN
    under .astype(np.int64) (and np.abs(INT64_MIN) stays negative), so
    they would slide past the magnitude check below and encode as
    garbage — the named refusal here is the enforcement a byzantine or
    diverged client cannot blind through masking.

    Field-overflow bound: the signed fixed-point magnitude |round(x·scale)|
    must stay ≤ (p−1)//2 — the field's signed half-range — or the value
    would alias across the negative/positive boundary (a large positive
    reading back as negative and vice versa) and every downstream sum
    would be silently garbage.  Out-of-range values raise a named
    ValueError instead of wrapping; both signs are pinned at the boundary
    in tests/test_mpc.py.  With the default scale 2^16 and p = 2^31−1 the
    usable float range is ±16383.999; aggregate sums share the same bound,
    so K summands must jointly satisfy K·max|x|·scale ≤ (p−1)//2 —
    callers that fold K rows pass ``max_abs=(p−1)//(2K)`` to enforce
    their per-summand slice of that budget (secagg client_row does),
    because a sum that wraps is undetectable after the fact."""
    x = np.asarray(x, np.float64)
    if x.size and not np.all(np.isfinite(x)):
        raise ValueError(
            "fixed-point quantize: non-finite input (inf/NaN) cannot be "
            "encoded in the field — clip or drop the row upstream")
    q = np.round(x * scale).astype(np.int64)
    bound = (p - 1) // 2
    if max_abs is not None:
        bound = min(int(max_abs), bound)
    if q.size and int(np.max(np.abs(q))) > bound:
        bad = float(np.max(np.abs(x)))
        why = ("the value would alias across the sign boundary after "
               "mod p" if bound == (p - 1) // 2 else
               "past the caller's per-summand share of the field range, "
               "the aggregate sum could cross the signed half-range and "
               "alias at dequantize")
        raise ValueError(
            f"fixed-point field overflow: |x|·scale reaches "
            f"{int(np.max(np.abs(q)))} > bound {bound} "
            f"(max |x| = {bad:g}, scale = {scale}) — {why}; reduce the "
            f"scale or clip the input")
    return _mod(q, p)


def dequantize(q: np.ndarray, scale: int = 2 ** 16,
               p: int = DEFAULT_PRIME) -> np.ndarray:
    """field → float, mapping the upper half back to negatives."""
    q = np.asarray(q, np.int64)
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / scale


# -- polynomial secret sharing (BGW) ----------------------------------------

def BGW_encoding(X: np.ndarray, N: int, T: int, p: int = DEFAULT_PRIME,
                 seed: int | None = None) -> np.ndarray:
    """Shamir/BGW: share secret array X (field elements) into N shares with
    threshold T (any T+1 reconstruct). Returns [N, *X.shape]
    (mpc_function.py:62-83)."""
    rs = np.random.RandomState(seed)
    X = np.mod(np.asarray(X, np.int64), p)
    coeffs = [X] + [rs.randint(0, p, X.shape).astype(np.int64)
                    for _ in range(T)]
    alphas = np.arange(1, N + 1, dtype=np.int64)
    shares = np.empty((N,) + X.shape, np.int64)
    for i, a in enumerate(alphas):
        acc = np.zeros(X.shape, dtype=object)
        apow = 1
        for c in coeffs:
            acc = acc + c.astype(object) * apow
            apow = (apow * int(a)) % p
        shares[i] = np.mod(acc, p).astype(np.int64)
    return shares


def _lagrange_coeffs_at(targets: np.ndarray, evals: np.ndarray,
                        p: int) -> np.ndarray:
    """W[i][j]: weight of eval point j when interpolating at target i."""
    W = np.empty((len(targets), len(evals)), np.int64)
    for ti, t in enumerate(targets):
        for j, aj in enumerate(evals):
            num, den = 1, 1
            for m, am in enumerate(evals):
                if m == j:
                    continue
                num = (num * ((int(t) - int(am)) % p)) % p
                den = (den * ((int(aj) - int(am)) % p)) % p
            W[ti, j] = (num * modinv(den, p)) % p
    return W


def BGW_decoding(shares: np.ndarray, worker_idx: np.ndarray,
                 p: int = DEFAULT_PRIME) -> np.ndarray:
    """Reconstruct the secret from ≥T+1 shares (rows of `shares` correspond
    to worker indices `worker_idx`, 0-based) — mpc_function.py:86-108."""
    alphas = np.asarray(worker_idx, np.int64) + 1
    W = _lagrange_coeffs_at(np.zeros(1, np.int64), alphas, p)[0]
    flat = shares.reshape(shares.shape[0], -1)
    out = modmat(W[None, :], flat, p)[0]
    return out.reshape(shares.shape[1:])


# -- Lagrange Coded Computing ------------------------------------------------

def LCC_encoding(X: np.ndarray, N: int, K: int, T: int = 0,
                 p: int = DEFAULT_PRIME, seed: int | None = None) -> np.ndarray:
    """Encode K data blocks (leading axis of X, shape [K, ...]) into N coded
    blocks via Lagrange interpolation through betas 1..K(+T random pads),
    evaluated at alphas K+T+1..K+T+N (mpc_function.py:111-170).  With T>0,
    T uniformly-random pad blocks give T-privacy."""
    rs = np.random.RandomState(seed)
    X = np.mod(np.asarray(X, np.int64), p)
    K_, rest = X.shape[0], X.shape[1:]
    assert K_ == K
    if T > 0:
        pads = rs.randint(0, p, (T,) + rest).astype(np.int64)
        X = np.concatenate([X, pads], axis=0)
    betas = np.arange(1, K + T + 1, dtype=np.int64)
    alphas = np.arange(K + T + 1, K + T + N + 1, dtype=np.int64)
    W = _lagrange_coeffs_at(alphas, betas, p)         # [N, K+T]
    flat = X.reshape(K + T, -1)
    out = modmat(W, flat, p)
    return out.reshape((N,) + rest)


def LCC_decoding(coded: np.ndarray, worker_idx: np.ndarray, N: int, K: int,
                 T: int = 0, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Recover the K data blocks from any K+T coded blocks
    (mpc_function.py:173-213)."""
    alphas_all = np.arange(K + T + 1, K + T + N + 1, dtype=np.int64)
    evals = alphas_all[np.asarray(worker_idx)]
    betas = np.arange(1, K + T + 1, dtype=np.int64)
    W = _lagrange_coeffs_at(betas, evals, p)          # [K+T, len(idx)]
    flat = coded.reshape(coded.shape[0], -1)
    out = modmat(W, flat, p)
    return out.reshape((K + T,) + coded.shape[1:])[:K]


# -- additive sharing + key agreement ----------------------------------------

def additive_shares(X: np.ndarray, N: int, p: int = DEFAULT_PRIME,
                    seed: int | None = None) -> np.ndarray:
    """Split X into N uniformly-random shares summing to X mod p
    (mpc_function.py:214-224)."""
    rs = np.random.RandomState(seed)
    X = np.mod(np.asarray(X, np.int64), p)
    shares = rs.randint(0, p, (N - 1,) + X.shape).astype(np.int64)
    last = np.mod(X.astype(object) - shares.astype(object).sum(axis=0),
                  p).astype(np.int64)
    return np.concatenate([shares, last[None]], axis=0)


def pk_gen(sk: int, g: int = 5, p: int = DEFAULT_PRIME) -> int:
    """Diffie-Hellman-style public key g^sk mod p (mpc_function.py:263-269)."""
    return pow(g, int(sk), p)


def shared_key(pk_other: int, sk_self: int, p: int = DEFAULT_PRIME) -> int:
    """pairwise shared secret pk_other^sk_self mod p (:271-275)."""
    return pow(int(pk_other), int(sk_self), p)
