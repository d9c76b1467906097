"""The port's MPC field arithmetic (fedml_tpu_torch/core/mpc.py) against
the JAX package's (fedml_tpu/core/mpc.py), bitwise: the same inputs give
the same int64 field elements, floats and Python ints, and the same
refusals (exception type and the thing the message names).  The cases
mirror tests/test_mpc.py and the mpc cases of
tests/test_advanced_algorithms.py, each run through both modules."""
import numpy as np
import pytest

from fedml_tpu.algorithms.turboaggregate import (
    lcc_coded_groups as jax_lcc_coded_groups)
from fedml_tpu.core import mpc as jmpc
from fedml_tpu_torch.algorithms.turboaggregate import lcc_coded_groups
from fedml_tpu_torch.core import mpc

P = mpc.DEFAULT_PRIME
OK = ((P - 1) // 2) / 2.0 ** 16          # the largest magnitude that fits


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_constants_match():
    assert mpc.DEFAULT_PRIME == jmpc.DEFAULT_PRIME == 2 ** 31 - 1


@pytest.mark.parametrize("x,kw", [
    ([0.0, 1.5, -1.5, 1234.5678, -9999.25, 1e-4, -1e-4], {}),
    ([-1.0], {}),
    ([OK, -OK], {}),
    ([0.5], {"max_abs": 2 ** 15}),
    ([OK], {"max_abs": 2 * ((P - 1) // 2)}),
    ([3.25, -7.5, 0.0, 16000.0], {}),
    ([0.1, -0.2], {"scale": 2 ** 10}),
    ([], {}),
])
def test_quantize_dequantize_bitwise(x, kw):
    x = np.asarray(x)
    q, jq = mpc.quantize(x, **kw), jmpc.quantize(x, **kw)
    _same(q, jq)
    scale = kw.get("scale", 2 ** 16)
    _same(mpc.dequantize(q, scale), jmpc.dequantize(jq, scale))


def test_quantize_random_rows_bitwise():
    x = np.random.RandomState(0).standard_normal(1000) * 100
    _same(mpc.quantize(x), jmpc.quantize(x))
    q = np.random.RandomState(1).randint(0, P, 1000).astype(np.int64)
    _same(mpc.dequantize(q), jmpc.dequantize(q))


@pytest.mark.parametrize("x,kw,match", [
    ([OK + 2.0 ** -16], {}, "fixed-point field overflow"),
    ([-(OK + 2.0 ** -16)], {}, "fixed-point field overflow"),
    ([1.0], {"max_abs": 2 ** 15}, "aggregate"),
    ([-1.0], {"max_abs": 2 ** 15}, "fixed-point field overflow"),
    ([np.inf, 0.5], {}, "non-finite"),
    ([-np.inf, 0.5], {}, "non-finite"),
    ([np.nan, 0.5], {}, "non-finite"),
])
def test_quantize_refusals_match(x, kw, match):
    with pytest.raises(ValueError, match=match) as ours:
        mpc.quantize(np.asarray(x), **kw)
    with pytest.raises(ValueError, match=match) as ref:
        jmpc.quantize(np.asarray(x), **kw)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("N,T,idx", [(5, 2, [0, 2, 4]), (7, 3, [0, 2, 4, 6]),
                                     (7, 3, [1, 3, 5, 6]), (7, 3, [0, 2, 4])])
def test_bgw_bitwise(N, T, idx):
    secret = mpc.quantize(np.array([3.25, -7.5, 0.0, 16000.0]))
    shares = mpc.BGW_encoding(secret, N, T, seed=11)
    _same(shares, jmpc.BGW_encoding(secret, N, T, seed=11))
    idx = np.asarray(idx)
    out = mpc.BGW_decoding(shares[idx], idx)
    _same(out, jmpc.BGW_decoding(shares[idx], idx))
    # T+1 shares reconstruct; T (one short) give another value
    assert np.array_equal(out, secret) == (len(idx) > T)


@pytest.mark.parametrize("K,N,T,idx", [(3, 8, 1, [1, 3, 5, 7]),
                                       (4, 8, 2, [0, 1, 3, 4, 6, 7]),
                                       (2, 3, 0, [0, 2])])
def test_lcc_bitwise(K, N, T, idx):
    X = np.random.RandomState(7).randint(0, P, (K, 5)).astype(np.int64)
    coded = mpc.LCC_encoding(X, N, K, T=T, seed=5)
    _same(coded, jmpc.LCC_encoding(X, N, K, T=T, seed=5))
    idx = np.asarray(idx)
    out = mpc.LCC_decoding(coded[idx], idx, N, K, T=T)
    _same(out, jmpc.LCC_decoding(coded[idx], idx, N, K, T=T))
    _same(out, X)


def test_additive_shares_bitwise():
    X = np.random.RandomState(3).randint(0, P, (6,)).astype(np.int64)
    shares = mpc.additive_shares(X, N=5, seed=17)
    _same(shares, jmpc.additive_shares(X, N=5, seed=17))
    total = np.mod(shares.astype(object).sum(axis=0), P).astype(np.int64)
    _same(total, X)


def test_modular_helpers_and_key_agreement_match():
    rs = np.random.RandomState(4)
    A = rs.randint(0, P, (3, 4)).astype(np.int64)
    B = rs.randint(0, P, (4, 2)).astype(np.int64)
    _same(mpc.modmat(A, B, P), jmpc.modmat(A, B, P))
    for a in (1, 2, 12345, P - 1):
        assert mpc.modinv(a, P) == jmpc.modinv(a, P)
        assert a * mpc.modinv(a, P) % P == 1
    for sk_a, sk_b in ((12345, 67890), (123457, 987653)):
        assert mpc.pk_gen(sk_a) == jmpc.pk_gen(sk_a)
        assert (mpc.shared_key(mpc.pk_gen(sk_b), sk_a)
                == mpc.shared_key(mpc.pk_gen(sk_a), sk_b)
                == jmpc.shared_key(jmpc.pk_gen(sk_b), sk_a))


@pytest.mark.parametrize("drop", [[1], [4], [1, 4]])
def test_lcc_coded_groups_with_dropped_workers(drop):
    updates = np.random.RandomState(0).randint(0, 1000, (3, 5)).astype(np.int64)
    rec = lcc_coded_groups(updates, N=6, K=3, T=1, drop=drop)
    _same(rec, jax_lcc_coded_groups(updates, N=6, K=3, T=1, drop=drop))
    _same(rec, updates)


def test_lcc_coded_groups_refuses_too_many_stragglers():
    updates = np.zeros((3, 2), np.int64)
    with pytest.raises(ValueError, match="too many stragglers"):
        lcc_coded_groups(updates, N=6, K=3, T=1, drop=[0, 1, 2])
