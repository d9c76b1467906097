"""The port's admission pipeline and adversary
(fedml_tpu_torch/async_/defense.py, adversary.py) against the JAX
package's, on the CPU.

* The stage math on clean, boosted, sign-flipped, NaN and ±inf rows: the
  same admit flag and reason, the clipped row at rtol 1e-6 (absolute floor
  1e-6 of its largest element), the same EW state at rtol 1e-6.
* A seeded sequence of 40 rows through UpdateAdmission gives JAX's admit
  and quarantine decisions, through screen() and through the screened
  fold (whose accumulator matches JAX's at the same tolerance).
* A quarantined NaN or ±inf row leaves the accumulator bitwise unchanged,
  and its only kernel call is the squared distance.
* The defended degenerate server (B = 1, canary only) commits bitwise what
  the undefended streaming server commits.
* The adversary is bitwise JAX's: the byzantine set, every attack mode's
  rows, the colluding rows, the stale latency, the dict form, and the
  data attacks' poisoned shards.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.async_ import adversary as jadv
from fedml_tpu.async_ import defense as jdef
from fedml_tpu.async_.staleness import AsyncBuffer as JaxBuffer
from fedml_tpu.data import federated as jfed
from fedml_tpu_torch import obs
from fedml_tpu_torch.async_ import adversary as tadv
from fedml_tpu_torch.async_ import defense as tdef
from fedml_tpu_torch.async_.defense import DefenseConfig, UpdateAdmission
from fedml_tpu_torch.async_.lifecycle import AsyncServerManager
from fedml_tpu_torch.async_.staleness import AsyncBuffer
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.data import federated as tfed

torch.set_num_threads(2)
P = 48
RTOL = 1e-6
SCREEN = dict(norm_bound=2.0, screen=True, z_max=4.0, cos_min=-0.5,
              screen_warmup=4)


def _close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=err_msg)


def _warm_state(rs):
    """A running reference after some accepted updates (both packages)."""
    ref = rs.randn(P).astype(np.float32) * 0.1
    mu = np.float32(np.linalg.norm(2.0 * ref))
    return ref, np.float32(10.0), mu, np.float32((0.2 * mu) ** 2)


def _row(kind, rs, g, ref):
    base = g + ref * 2.0 + rs.randn(P).astype(np.float32) * 0.02
    if kind == "boosted":
        return g + 40.0 * (base - g)
    if kind == "signflip":
        return g - (base - g)
    if kind in ("nan", "inf", "-inf"):
        base[7] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[kind]
    return base


@pytest.mark.parametrize("kind", ["clean", "boosted", "signflip", "nan",
                                  "inf", "-inf"])
def test_stage_math_matches_jax(kind):
    rs = np.random.RandomState(1)
    cfg = DefenseConfig(**SCREEN)
    g = rs.randn(P).astype(np.float32)
    ref, n, mu, m2 = _warm_state(rs)
    row = _row(kind, rs, g, ref)
    jout = jdef._make_stage_fn(jdef.DefenseConfig(**SCREEN))(
        jnp.asarray(row), jnp.asarray(g), jnp.asarray(ref), jnp.float32(n),
        jnp.float32(mu), jnp.float32(m2))
    jclipped, jok, jreason, jref, jn, jmu, jm2 = (np.asarray(a) for a in jout)
    t = torch.tensor
    clipped, clip, ok, reason, tref, tn, tmu, tm2 = tdef._make_stage_fn(cfg)(
        t(row), t(g), t(ref), t(n), t(mu), t(m2))
    assert bool(ok) == bool(jok) and int(reason) == int(jreason)
    assert (kind in ("clean",)) == bool(ok)
    if bool(ok):
        _close(clipped.numpy(), jclipped)
    for a, b in ((tref, jref), (tn, jn), (tmu, jmu), (tm2, jm2)):
        _close(a.numpy(), b)


def _sequence(seed=5, n=40):
    rs = np.random.RandomState(seed)
    step = rs.randn(P).astype(np.float32) * 0.1
    rows = []
    for i in range(n):
        r = step + rs.randn(P).astype(np.float32) * 0.03
        if i >= 10 and i % 7 == 0:
            r = 30.0 * r                       # boosted
        elif i >= 10 and i % 9 == 0:
            r = -r                             # sign-flipped
        elif i % 13 == 5:
            r[3] = np.nan
        rows.append(r)
    return rows


def test_update_admission_sequence_matches_jax():
    """40 seeded rows through screen() and through the screened fold: the
    same decisions as JAX's, in order, and the screened accumulator."""
    rows = _sequence()
    jadm = jdef.UpdateAdmission(jdef.DefenseConfig(**SCREEN), P)
    tadm = UpdateAdmission(DefenseConfig(**SCREEN), P, device="cpu")
    for a, g in ((jadm, jnp.zeros((P,), jnp.float32)), (tadm, np.zeros(P))):
        a.note_global(0, g)
    jd = [jadm.screen(r, sender=i, version=0)[:2] for i, r in enumerate(rows)]
    td = [tadm.screen(r, sender=i, version=0)[:2] for i, r in enumerate(rows)]
    assert td == jd
    assert {w for ok, w in jd if not ok} == {"nonfinite", "norm_z", "cosine"}
    assert tadm.report() == jadm.report()
    # the screened fold, streaming with B = 1
    jbuf = JaxBuffer(64, P, streaming=True, staleness_mode="polynomial")
    tbuf = AsyncBuffer(64, P, streaming=True, staleness_mode="polynomial",
                       device="cpu")
    jadm = jdef.UpdateAdmission(jdef.DefenseConfig(**SCREEN), P)
    tadm = UpdateAdmission(DefenseConfig(**SCREEN), P, device="cpu")
    jadm.bind_fold("polynomial", 0.5, 4.0)
    tadm.bind_fold("polynomial", 0.5, 4.0)
    jadm.note_global(0, jnp.zeros((P,), jnp.float32))
    tadm.note_global(0, np.zeros(P, np.float32))
    jd, td = [], []
    for i, r in enumerate(rows):
        jd.append(jbuf.add_screened(r, 3.0, i % 3, jadm, sender=i,
                                    version=0)[:2])
        td.append(tbuf.add_screened(r, 3.0, i % 3, tadm, sender=i,
                                    version=0)[:2])
    assert td == jd and tbuf.count == jbuf.count
    _close(tbuf.acc.numpy(), jbuf.acc)
    _close(tbuf.wsum.numpy(), jbuf.wsum)
    state, jstate = tadm.state(), jadm.state()
    assert set(state) == set(jstate)
    for k in state:
        _close(state[k], jstate[k], err_msg=k)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("bound", [None, 1.0])
def test_quarantined_row_leaves_the_accumulator_bitwise(monkeypatch, bad,
                                                        bound):
    calls = {"client_sqnorms": 0, "fold": 0, "clip_fold": 0}
    for name in calls:
        fn = getattr(tdef, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tdef, name, counted)
    rs = np.random.RandomState(2)
    adm = UpdateAdmission(DefenseConfig(norm_bound=bound), P, device="cpu")
    adm.bind_fold("constant", 0.5, 4.0)
    adm.note_global(0, rs.randn(P).astype(np.float32))
    buf = AsyncBuffer(4, P, streaming=True, device="cpu")
    assert buf.add_screened(rs.randn(P).astype(np.float32), 2.0, 0.0,
                            adm)[0]
    acc, wsum = buf.acc.clone(), buf.wsum.clone()
    before = dict(calls)
    row = rs.randn(P).astype(np.float32)
    row[11] = bad
    ok, why, full = buf.add_screened(row, 2.0, 0.0, adm, sender=3)
    assert (ok, why, full) == (False, "nonfinite", False)
    assert torch.equal(buf.acc, acc) and torch.equal(buf.wsum, wsum)
    assert buf.count == 1 and torch.isfinite(buf.acc).all()
    assert {k: calls[k] - before[k] for k in calls} == {
        "client_sqnorms": 1, "fold": 0, "clip_fold": 0}
    assert before == ({"client_sqnorms": 1, "fold": 1, "clip_fold": 0}
                      if bound is None else
                      {"client_sqnorms": 1, "fold": 0, "clip_fold": 1})


def _server(template, defense):
    return AsyncServerManager(
        template, total_commits=2, buffer_k=3, rank=0, size=1,
        backend="INPROC", streaming=True, redispatch=False, defense=defense,
        router=InProcRouter(), device="cpu")


def test_defended_degenerate_ingest_is_bitwise_the_undefended():
    """The ONE insert path, driven with one arrival sequence: the degenerate
    defense (B = 1, canary only) commits bitwise the undefended streaming
    server's model, which matches the JAX server's."""
    from fedml_tpu.async_ import AsyncServerManager as JaxServer
    from fedml_tpu.comm.inproc import InProcRouter as JaxRouter
    rs = np.random.RandomState(8)
    w, b = rs.randn(6, 5).astype(np.float32), rs.randn(3).astype(np.float32)
    template = {"b": torch.tensor(b), "w": torch.tensor(w)}
    P_ = 512
    rows = np.zeros((6, P_), np.float32)
    rows[:, :33] = rs.randn(6, 33)
    servers = [_server(template, None), _server(template, DefenseConfig())]
    jax_srv = JaxServer({"params": {"w": w, "b": b}}, total_commits=2,
                        buffer_k=3, rank=0, size=1, backend="INPROC",
                        streaming=True, redispatch=False,
                        router=JaxRouter())
    try:
        for srv in servers:
            for i in range(6):
                srv._ingest_row(sender=1, row=rows[i].copy(),
                                weight=float(10 + i), dispatched=0)
        for i in range(6):
            jax_srv._ingest_row(sender=1, row=rows[i, :33].copy(),
                                weight=float(10 + i), dispatched=0)
        assert servers[0].version == servers[1].version == 2
        for k in template:
            assert torch.equal(servers[0].variables[k],
                               servers[1].variables[k])
            _close(servers[0].variables[k].numpy(),
                   jax_srv.variables["params"][k])
    finally:
        for srv in servers + [jax_srv]:
            srv.finish()


def test_admission_state_config_and_metrics(tmp_path):
    rs = np.random.RandomState(6)
    cfg = DefenseConfig(norm_bound=2.0, screen=True, screen_warmup=4)
    adm = UpdateAdmission(cfg, P, device="cpu")
    adm.note_global(0, np.zeros(P, np.float32))
    for i in range(6):
        assert adm.screen(rs.randn(P).astype(np.float32) * 0.1, sender=i,
                          version=0)[0]
    fresh = UpdateAdmission(cfg, P, device="cpu")
    fresh.load_state(adm.state())
    assert fresh.accepted == adm.accepted == 6
    assert torch.equal(fresh._ref, adm._ref) and torch.equal(fresh._mu,
                                                             adm._mu)
    with pytest.raises(ValueError, match="shape mismatch"):
        UpdateAdmission(cfg, P + 1, device="cpu").load_state(adm.state())
    with pytest.raises(ValueError, match="dp_clip"):
        DefenseConfig(dp_noise=1.0)
    with pytest.raises(ValueError, match="unknown bucket combine"):
        DefenseConfig(combine="krum")
    obs.reset()
    obs.configure(str(tmp_path), install_signal=False, export_at_exit=False)
    try:
        adm = UpdateAdmission(cfg, P, device="cpu")   # this registry's
        before = obs.counter("async_updates_quarantined_total",
                             reason="nonfinite").value
        bad = rs.randn(P).astype(np.float32)
        bad[0] = np.nan
        assert adm.screen(bad, sender=3, version=0)[:2] == (False,
                                                             "nonfinite")
        assert obs.counter("async_updates_quarantined_total",
                           reason="nonfinite").value == before + 1
        evs = [e for e in obs.tracer().events()
               if e.get("name") == "defense.quarantine"]
        assert evs and evs[-1]["args"]["reason"] == "nonfinite"
    finally:
        obs.reset()


# -- the adversary ------------------------------------------------------------

@pytest.mark.parametrize("mode,collude", [
    ("signflip", False), ("boost", False), ("gaussian", False),
    ("mixed", False), ("gaussian", True)])
def test_adversary_rows_are_jax_bitwise(mode, collude):
    kw = dict(mode=mode, frac=0.25, boost=7.0, noise_std=2.0,
              collude=collude, seed=11)
    a = tadv.AdversarySim(tadv.AttackConfig(**kw), 16)
    j = jadv.AdversarySim(jadv.AttackConfig(**kw), 16)
    assert a.byzantine == j.byzantine and len(a.byzantine) == 4
    rs = np.random.RandomState(0)
    g = rs.randn(20).astype(np.float32)
    for version in (3, 4):
        for cid in range(16):
            row = rs.randn(20).astype(np.float32)
            got = a.corrupt_row(cid, torch.tensor(row), g, version)
            want = j.corrupt_row(cid, row, g, version)
            if cid not in a.byzantine:
                assert torch.equal(got, torch.tensor(row))
                continue
            np.testing.assert_array_equal(got, want)
    assert a.trace() == j.trace() and a.injected == j.injected


def test_adversary_stale_latency_dict_form_and_config():
    kw = dict(mode="boost", frac=0.5, stale=True, stale_lag=7.5, boost=3.0,
              seed=0)
    a = tadv.AdversarySim(tadv.AttackConfig(**kw), 8)
    j = jadv.AdversarySim(jadv.AttackConfig(**kw), 8)
    for cid in range(8):
        assert a.stale_extra_latency(cid) == j.stale_extra_latency(cid)
    byz = sorted(a.byzantine)[0]
    rs = np.random.RandomState(3)
    new = {"k": rs.randn(3, 2).astype(np.float32),
           "b": rs.randn(4).astype(np.float32)}
    base = {k: rs.randn(*v.shape).astype(np.float32) for k, v in new.items()}
    got = a.corrupt_update(byz, {k: torch.tensor(v) for k, v in new.items()},
                           {k: torch.tensor(v) for k, v in base.items()}, 2)
    # JAX flattens in sorted leaf order, the port in the dict's: compare
    # leaf by leaf (boost is elementwise)
    want = j.corrupt_update(byz, new, base, 2)
    for k in new:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="unknown attack mode"):
        tadv.AttackConfig(mode="meteor")
    with pytest.raises(ValueError, match="frac"):
        tadv.AttackConfig(mode="boost", frac=1.5)


def _data(mod, n_clients=8, per=12, bs=4, seed=0):
    rs = np.random.RandomState(seed)
    n = n_clients * per
    x = rs.rand(n, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)}
    ev = mod.build_eval_shard(x[:bs], y[:bs], bs)
    return mod.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


@pytest.mark.parametrize("mode", ["labelflip", "backdoor", "mixed", "boost"])
def test_data_attacks_poison_as_jax(mode):
    kw = dict(mode=mode, frac=0.25, target_label=2, poison_frac=0.5, seed=4)
    tcfg, jcfg = tadv.AttackConfig(**kw), jadv.AttackConfig(**kw)
    tdata = tadv.apply_data_attack(_data(tfed), tcfg,
                                   tadv.AdversarySim(tcfg, 8))
    jdata = jadv.apply_data_attack(_data(jfed), jcfg,
                                   jadv.AdversarySim(jcfg, 8))
    for k in ("x", "y", "mask"):
        np.testing.assert_array_equal(np.asarray(tdata.client_shards[k]),
                                      np.asarray(jdata.client_shards[k]))
    changed = not np.array_equal(tdata.client_shards["y"],
                                 _data(tfed).client_shards["y"])
    assert changed == (mode != "boost")
