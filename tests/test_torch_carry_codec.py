"""The PyTorch port's carry codecs (fedml_tpu_torch/parallel/carry_codec.py)
against the JAX package's (fedml_tpu/parallel/carry_codec.py).

The codecs are numpy on both sides, so the contract is bitwise: for the
same vector and block, every codec's encoded bytes, its decoded vector,
the error-feedback residuals over rounds, the top-k selection (its tie
order included: the k largest magnitudes in descending order, ties to
the lower index, as XLA's top_k orders them) and the replicated
reconstruction mirror are the JAX codec's, byte for byte.  The port's
checkpoint (utils/checkpoint.py, its own format) carries the stateful
codecs' state across a resume without changing a byte of what follows.
"""
import numpy as np
import pytest

from fedml_tpu.parallel import carry_codec as jcc
from fedml_tpu_torch.parallel import carry_codec as tcc
from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager


def _vec(n, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(n)).astype(np.float32)


def _tied(n, seed=0):
    """Few distinct magnitudes, both signs: top-k must break many ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, n) * 0.5).astype(np.float32)


VECTORS = {
    "gauss": lambda n, s: _vec(n, s),
    "tied": _tied,
    "zeros": lambda n, s: np.zeros(n, np.float32),
    "constant": lambda n, s: np.full(n, 1.25, np.float32),
    "tiny": lambda n, s: _vec(n, s, scale=1e-30),
}
DIMS = (1, 7, 64, 4097, 20_000)


def _pair(name, **kw):
    return (jcc.make_carry_codec(name, **kw),
            tcc.make_carry_codec(name, **kw))


@pytest.mark.parametrize("kind", sorted(VECTORS))
@pytest.mark.parametrize("name", tcc.CARRY_CODECS)
def test_encode_decode_bitwise_jax(name, kind):
    """One round of every codec on every vector kind and size: the same
    bytes, the same decoded vector, the same payload size."""
    for dim in DIMS:
        for chunk in (64, tcc.DEFAULT_CHUNK):
            j, t = _pair(name, chunk=chunk)
            v = VECTORS[kind](dim, dim)
            jb, tb = j.encode(0, v), t.encode(0, v)
            assert tb == jb, (name, kind, dim, chunk)
            assert len(tb) == t.encoded_nbytes(dim) == j.encoded_nbytes(dim)
            assert t.decode(tb).tobytes() == j.decode(jb).tobytes()


@pytest.mark.parametrize("ratio", (1, 3, 16))
def test_topk_selection_order_is_xla_top_k(ratio):
    """The numpy selection against lax.top_k itself: indices and values
    in its order, ties to the lower index."""
    import jax
    import jax.numpy as jnp
    for seed in range(4):
        for v in (_tied(997, seed), _vec(997, seed),
                  np.zeros(50, np.float32)):
            k = max(1, v.size // ratio)
            _, want = jax.lax.top_k(jnp.abs(v), k)
            idx, vals = tcc.topk_select(v, k)
            assert idx.dtype == np.uint32
            np.testing.assert_array_equal(idx, np.asarray(want))
            assert vals.tobytes() == v[np.asarray(want)].tobytes()


@pytest.mark.parametrize("name", ("int8_ef", "topk_ef"))
def test_ef_trajectories_bitwise_jax(name):
    """Six rounds of two blocks: every round's bytes, the residual (or
    reconstruction mirror) state and, for topk_ef, the integrated
    reconstruction agree bitwise with the JAX codec's."""
    j, t = _pair(name, chunk=128)
    for r in range(6):
        for b in (0, 1):
            v = _vec(3000, seed=10 * b + r) + r
            jb, tb = j.encode(b, v), t.encode(b, v)
            assert tb == jb, (r, b)
            if name == "topk_ef":
                assert (t.integrate(b, tb).tobytes()
                        == j.integrate(b, jb).tobytes())
        js, ts = j.state_dict(), t.state_dict()
        assert sorted(ts["residual"]) == sorted(js["residual"])
        for k in js["residual"]:
            assert ts["residual"][k].dtype == js["residual"][k].dtype
            assert (ts["residual"][k].tobytes()
                    == js["residual"][k].tobytes())


def test_ef_residuals_converge_and_retain_blocks():
    """int8_ef: the decoded sum over rounds tracks the true sum within a
    single round's error; retain_blocks drops unowned residuals exactly
    as JAX's (topk_ef keeps every mirror)."""
    t = tcc.Int8EFCarryCodec(chunk=64)
    true_sum = np.zeros(512)
    got_sum = np.zeros(512)
    for r in range(20):
        v = _vec(512, seed=r)
        true_sum += v
        got_sum += t.decode(t.encode(0, v))
    one_round = np.abs(t._residual[0]).max()
    assert np.abs(got_sum - true_sum).max() <= one_round + 1e-9
    for name in ("int8_ef", "topk_ef"):
        j, t = _pair(name, chunk=64)
        for b in range(4):
            v = _vec(256, seed=b)
            jb, tb = j.encode(b, v), t.encode(b, v)
            if name == "topk_ef":
                j.integrate(b, jb)
                t.integrate(b, tb)
        j.retain_blocks([1, 3])
        t.retain_blocks([1, 3])
        assert sorted(t.state_dict()["residual"]) == \
            sorted(j.state_dict()["residual"])


@pytest.mark.parametrize("name", ("int8_ef", "topk_ef"))
def test_ef_state_checkpoint_roundtrip(tmp_path, name):
    """The codec state rides the port's checkpoint as extra_state: a
    codec restored from it emits the uninterrupted codec's bytes on
    every later round (and those are JAX's)."""
    j, t = _pair(name, chunk=64)
    for r in range(3):
        for b in (0, 1):
            v = _vec(512, seed=10 * b + r)
            jb, tb = j.encode(b, v), t.encode(b, v)
            if name == "topk_ef":
                j.integrate(b, jb)
                t.integrate(b, tb)
    ck = FedCheckpointManager(str(tmp_path / "carry"))
    variables = {"w": np.zeros(2, np.float32)}
    ck.save(3, variables, (), extra_state=t.state_dict())
    step, _, _, extra = ck.restore(variables, (),
                                   extra_template=t.state_dict())
    assert step == 3
    resumed = tcc.make_carry_codec(name, chunk=64)
    resumed.load_state_dict(extra)
    for r in range(3, 6):
        for b in (0, 1):
            v = _vec(512, seed=10 * b + r)
            rb, tb, jb = resumed.encode(b, v), t.encode(b, v), j.encode(b, v)
            assert rb == tb == jb, (r, b)
            if name == "topk_ef":
                for c, buf in ((resumed, rb), (t, tb), (j, jb)):
                    c.integrate(b, buf)


def test_registry_and_named_errors():
    assert [tcc.make_carry_codec(n).name for n in tcc.CARRY_CODECS] == \
        list(jcc.CARRY_CODECS)
    assert (tcc.DEFAULT_CHUNK, tcc.DEFAULT_TOPK_RATIO) == \
        (jcc.DEFAULT_CHUNK, jcc.DEFAULT_TOPK_RATIO)
    with pytest.raises(ValueError, match="unknown carry codec"):
        tcc.make_carry_codec("fp8")
    with pytest.raises(ValueError, match="positive"):
        tcc.CarryCodec(chunk=0)
    with pytest.raises(ValueError, match="positive"):
        tcc.TopKCarryCodec(topk_ratio=0)
    with pytest.raises(ValueError, match="carries no state"):
        tcc.CarryCodec().load_state_dict({"residual": {}})
    bad = _vec(64)
    bad[3] = np.nan
    for name in ("int8", "topk"):
        with pytest.raises(ValueError, match="non-finite carry for block 5"):
            tcc.make_carry_codec(name).encode(5, bad)
    # a payload from another codec's width is named, not misread
    with pytest.raises(ValueError, match="mixed-codec"):
        tcc.Int8CarryCodec(chunk=64).decode(
            tcc.Int8CarryCodec(chunk=32).encode(0, _vec(256)))
    with pytest.raises(ValueError, match="mixed-codec"):
        tcc.TopKCarryCodec(topk_ratio=8).decode_pairs(
            tcc.TopKCarryCodec(topk_ratio=16).encode(0, _vec(256)))
    # a <= k-sparse vector round-trips bitwise through top-k
    v = np.zeros(160, np.float32)
    v[[3, 77, 150]] = [1.5, -2.0, 0.25]
    t = tcc.TopKCarryCodec(topk_ratio=16)
    assert t.decode(t.encode(0, v)).tobytes() == v.tobytes()
