"""The port's secure aggregation (fedml_tpu_torch/secure/secagg.py) against
the JAX package's, on the CPU, bitwise throughout: pairwise masks cancel
in the integer field or not at all.

* the masks, the keyring (secret and public keys, escrowed BGW shares),
  every client row, the DP rows per (seed, client, round) and the
  reconstructed keys equal JAX's word for word;
* the masked field sum equals the plain fixed-point sum, and equals the
  JAX aggregator's, for a full cohort, after a dropout before and after
  upload (byte-identical to a clean survivor-only round), and after a
  re-upload;
* a below-threshold survivor set is refused by name, then recovers;
* the async server quarantines a plain uplink to a secure server and a
  masked one to a plain server by name, and the secure async messaging
  rounds commit (its masked words bitwise the plain sum inside).
"""
import logging

import numpy as np
import pytest
import torch

from fedml_tpu import secure as jsec
from fedml_tpu_torch.async_.lifecycle import (AsyncMessage,
                                              AsyncServerManager)
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.secure import (SecAggBelowThreshold, SecAggConfig,
                                    SecureAggregator, pairwise_mask)

torch.set_num_threads(2)
P = mpc.DEFAULT_PRIME


def _plain_field_sum(cfg, dim, contribs):
    """The unmasked truth: Σ [quantize(w·x), quantize(w)] mod p."""
    expected = np.zeros(dim + 1, np.int64)
    for flat, w in contribs.values():
        q = np.empty(dim + 1, np.int64)
        q[:dim] = mpc.quantize(np.asarray(flat, np.float64) * w, cfg.scale,
                               cfg.prime)
        q[dim] = mpc.quantize(np.array([float(w)]), cfg.scale, cfg.prime)[0]
        expected = (expected + q) % cfg.prime
    return expected


def _mk(n=5, dim=32, seed=9, jax=False, **cfg_kw):
    ids = list(range(1, n + 1))
    if jax:
        cfg = jsec.SecAggConfig(seed=seed, **cfg_kw)
        agg = jsec.SecureAggregator(cfg, ids, dim)
    else:
        cfg = SecAggConfig(seed=seed, **cfg_kw)
        agg = SecureAggregator(cfg, ids, dim, device="cpu")
    rs = np.random.RandomState(21)
    contribs = {c: (rs.randn(dim) * 0.05, float(rs.randint(1, 40)))
                for c in ids}
    return cfg, agg, contribs


def _upload(agg, contribs, cids, round_idx=0):
    for c in cids:
        agg.escrow(c)
        flat, w = contribs[c]
        agg.fold(c, agg.client_row(c, round_idx, flat, w))


def test_masks_keyring_and_client_rows_are_jax_bitwise():
    for key, rnd in ((12345, 0), (2 ** 40 + 7, 3), (P - 1, 17)):
        np.testing.assert_array_equal(pairwise_mask(key, rnd, 1000),
                                      jsec.pairwise_mask(key, rnd, 1000))
    assert not np.array_equal(pairwise_mask(5, 0, 64), pairwise_mask(5, 1, 64))
    for dp in ({}, {"dp_clip": 0.2, "dp_noise": 1e-2}):
        cfg, agg, contribs = _mk(**dp)
        jcfg, jagg, _ = _mk(jax=True, **dp)
        kr, jkr = agg.keyring, jagg.keyring
        assert kr.sk == jkr.sk and kr.pk == jkr.pk
        assert agg.threshold == jagg.threshold == 3
        for c in contribs:
            agg.escrow(c)
            jagg.escrow(c)
            np.testing.assert_array_equal(kr._shares[c], jkr._shares[c])
            for rnd in (0, 4):
                flat, w = contribs[c]
                np.testing.assert_array_equal(
                    agg.client_row(c, rnd, flat, w),
                    jagg.client_row(c, rnd, flat, w))
        assert kr.reconstruct_sk(3, [1, 2, 4]) == kr.sk[3] == \
            jkr.reconstruct_sk(3, [1, 2, 4])


def test_masked_field_sum_is_the_plain_fixed_point_sum_bitwise():
    cfg, agg, contribs = _mk()
    _, jagg, _ = _mk(jax=True)
    _upload(agg, contribs, contribs)
    _upload(jagg, contribs, contribs)
    words, included = agg.field_sum(0, agg.arrived)
    assert included == sorted(contribs)
    np.testing.assert_array_equal(words, _plain_field_sum(cfg, agg.dim,
                                                          contribs))
    np.testing.assert_array_equal(words, jagg.field_sum(0, jagg.arrived)[0])
    # a single masked row is not its plain row
    flat, w = contribs[1]
    q = _plain_field_sum(cfg, agg.dim, {1: (flat, w)})
    assert not np.array_equal(agg.client_row(1, 0, flat, w).astype(np.int64),
                              q)
    acc, wsum, inc = agg.commit(0, agg.arrived)
    jacc, jwsum, jinc = jagg.commit(0, jagg.arrived)
    assert acc.tobytes() == jacc.tobytes() and wsum == jwsum and inc == jinc
    expect = sum(np.asarray(f, np.float64) * w for f, w in contribs.values())
    np.testing.assert_allclose(acc, expect, atol=len(contribs) / cfg.scale)
    assert agg.count == 0


@pytest.mark.parametrize("phase", ["pre_upload", "post_upload"])
def test_dropout_recovery_byte_identical_to_clean_survivor_round(phase):
    dead = 3
    cfg, agg, contribs = _mk()
    _, jagg, _ = _mk(jax=True)
    survivors = [c for c in contribs if c != dead]
    uploaders = survivors if phase == "pre_upload" else list(contribs)
    for a in (agg, jagg):
        _upload(a, contribs, uploaders)
        a.escrow(dead)
    words, included = agg.field_sum(0, survivors)
    assert included == survivors
    np.testing.assert_array_equal(
        words, _plain_field_sum(cfg, agg.dim,
                                {c: contribs[c] for c in survivors}))
    np.testing.assert_array_equal(words, jagg.field_sum(0, survivors)[0])
    acc, wsum, _ = agg.commit(0, survivors, reset=False)
    clean = SecureAggregator(SecAggConfig(seed=cfg.seed), survivors,
                             agg.dim, device="cpu")
    _upload(clean, contribs, survivors)
    acc2, wsum2, _ = clean.commit(0, survivors, reset=False)
    assert acc.tobytes() == acc2.tobytes() and wsum == wsum2
    # field_sum and commit each rebuilt the dead client's masks
    assert agg.report()["recovered_rounds"] == 2


def test_below_threshold_refuses_by_name_then_recovers():
    cfg, agg, contribs = _mk(n=5, threshold=4)
    _upload(agg, contribs, [1, 2, 3])
    for c in (4, 5):
        agg.escrow(c)
    with pytest.raises(SecAggBelowThreshold, match="survivors"):
        agg.commit(0, [1, 2, 3])
    assert agg.arrived == [1, 2, 3]
    flat, w = contribs[4]
    agg.fold(4, agg.client_row(4, 0, flat, w))
    words, included = agg.field_sum(0, [1, 2, 3, 4])
    assert included == [1, 2, 3, 4]
    np.testing.assert_array_equal(
        words, _plain_field_sum(cfg, agg.dim,
                                {c: contribs[c] for c in (1, 2, 3, 4)}))
    with pytest.raises(ValueError, match="threshold"):
        _mk(n=3, threshold=7)
    with pytest.raises(ValueError, match="dp_noise"):
        SecAggConfig(dp_noise=1e-3)


def test_reupload_backs_out_and_the_fold_runs_in_int64():
    cfg, agg, contribs = _mk()
    _upload(agg, contribs, contribs)
    assert agg._acc.dtype == torch.int64 and agg._acc.device.type == "cpu"
    flat, _w = contribs[2]
    agg.fold(2, agg.client_row(2, 0, flat, 7.0))
    contribs2 = {**contribs, 2: (flat, 7.0)}
    words, _ = agg.field_sum(0, agg.arrived)
    np.testing.assert_array_equal(words, _plain_field_sum(cfg, agg.dim,
                                                          contribs2))
    with pytest.raises(ValueError, match="unknown secagg client"):
        agg.fold(9, np.zeros(agg.words, np.uint32))
    with pytest.raises(ValueError, match="u32 words"):
        agg.fold(1, np.zeros(3, np.uint32))


def test_quantizer_refusal_is_the_surviving_norm_bound():
    cfg, agg, contribs = _mk()
    flat = np.full(agg.dim, 1e4)
    for a in (agg, _mk(jax=True)[1]):
        with pytest.raises(ValueError, match="overflow"):
            a.client_row(1, 0, flat, 1.0)
    bad = np.zeros(agg.dim)
    bad[0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        agg.client_row(1, 0, bad, 1.0)


# -- the async server's config-skew quarantine -------------------------------

def _server(secure):
    template = {"w": torch.zeros(4, 2), "b": torch.zeros(2)}
    return AsyncServerManager(
        template, total_commits=1, buffer_k=2, rank=0, size=3,
        backend="INPROC", redispatch=False, router=InProcRouter(),
        secure=SecAggConfig(seed=1) if secure else None, device="cpu")


@pytest.mark.parametrize("secure", [True, False])
def test_skewed_uplinks_are_quarantined_by_name(caplog, secure):
    srv = _server(secure)
    try:
        msg = Message(AsyncMessage.MSG_TYPE_C2S_ASYNC_RESULT, 1, 0)
        if secure:      # a plain uplink to a secure server
            msg.add_params("model_params", {"w": torch.ones(4, 2),
                                            "b": torch.ones(2)})
        else:           # masked words to a plain server
            msg.add_params("model_params", np.zeros(11, np.uint32))
            msg.add_params(AsyncMessage.MSG_ARG_KEY_SECAGG, {"round": 0})
        msg.add_params("num_samples", 3.0)
        msg.add_params("model_version", 0)
        with caplog.at_level(logging.WARNING,
                             logger="fedml_tpu_torch.async_.lifecycle"):
            srv._handle_result(msg)
        assert srv.buffer.count == 0 and srv.version == 0
        assert "config skew" in caplog.text
        assert ("PLAIN" if secure else "MASKED") in caplog.text
    finally:
        srv.finish()


def test_secure_server_commits_the_plain_weighted_mean():
    """Masked uplinks folded by the server's field fold unmask to the plain
    fixed-point sum; the commit installs Σ w·x / Σ w; a stale-round uplink
    is quarantined by version."""
    srv = _server(True)
    try:
        sec = srv._secure
        assert sec.dim == 10 and sec.words == 11
        rs = np.random.RandomState(3)
        rows = {1: (rs.randn(10) * 0.1, 4.0), 2: (rs.randn(10) * 0.1, 6.0)}
        srv._ingest_secure(1, sec.client_row(1, 5, *rows[1]), dispatched=5)
        assert sec.count == 0                   # masked for another round
        words = {c: sec.client_row(c, 0, f, w) for c, (f, w) in rows.items()}
        srv._ingest_secure(1, words[1], dispatched=0)
        srv._ingest_secure(2, words[2], dispatched=0)
        assert srv.version == 1 and srv.updates_committed == 2
        expect = (rows[1][0] * 4.0 + rows[2][0] * 6.0) / 10.0
        got = torch.cat([srv.variables["w"].reshape(-1),
                         srv.variables["b"]]).numpy()
        np.testing.assert_allclose(got, expect, atol=4 / SecAggConfig().scale)
    finally:
        srv.finish()
