"""The port's threefry2x32 PRNG is bit-equal to ``jax.random`` on the
entry points the engine draws: ``randint(fold_in(PRNGKey(seed),
rid & 0x7FFFFFFF), (E,), lo, hi)`` over a batch of requests."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import prng  # noqa: E402

# 1000 consecutive rids, the pool's insert rid space (1 << 28) and the
# & 0x7FFFFFFF wrap: rids at and past 2^31 fold in as rid - 2^31
RIDS = np.concatenate([
    np.arange(1000), (1 << 28) + np.arange(8),
    np.array([2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1, 2**31 + 999,
              2**32 - 1, 2**32, 3 * 2**31 + 5])]).astype(np.int64)


def _data(rids):
    return (rids & 0x7FFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 3, 99, 2**31 - 1, 2**32 - 1])
def test_prng_key_bit_equal(seed):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 3])
def test_fold_in_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    data = _data(RIDS)
    want = np.asarray(jax.vmap(lambda d: jax.random.fold_in(key, d))(
        jnp.asarray(data)))
    got = prng.fold_in(prng.prng_key(seed), data)
    np.testing.assert_array_equal(got, want)
    # the engine folds one Python int at a time: same bits
    for rid in (0, 2**31 + 1, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(seed), [rid & 0x7FFFFFFF])[0],
            np.asarray(jax.random.fold_in(key, rid & 0x7FFFFFFF)))


@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("lo,hi", [
    (0, 2000), (0, 1_000_000), (100, 1000), (1500, 2000),
    (999_000, 1_000_000), (0, 65536), (7, 8), (5, 5), (9, 3)])
def test_randint_bit_equal(n, lo, hi):
    """Scalar bounds, incl. power-of-two and unit spans and hi <= lo (JAX
    returns lo)."""
    keys = prng.fold_in(prng.prng_key(0), _data(RIDS))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (n,), lo, hi))(jnp.asarray(keys)))
    got = prng.randint(keys, n, np.full(len(keys), lo), np.full(len(keys), hi))
    np.testing.assert_array_equal(got, want)


def test_randint_per_request_segments_bit_equal():
    """Per-request [lo, hi) bounds (the retrieval-class entry segments), as
    the engine's batched admission draws them."""
    keys = prng.fold_in(prng.prng_key(3), _data(RIDS))
    i = np.arange(len(keys))
    lo = np.where(i % 3 == 0, 0, np.where(i % 3 == 1, 1000, 123_456))
    hi = np.where(i % 2 == 0, 1_000_000, lo + 1 + (i * 7919) % 50_000)
    want = np.asarray(jax.vmap(
        lambda k, a, b: jax.random.randint(k, (16,), a, b))(
        jnp.asarray(keys), jnp.asarray(lo, jnp.int32),
        jnp.asarray(hi, jnp.int32)))
    np.testing.assert_array_equal(prng.randint(keys, 16, lo, hi), want)
    assert want.min() >= 0 and want.max() < 1_000_000


def test_randint_rejects_out_of_int32_bounds():
    keys = prng.fold_in(prng.prng_key(0), [1])
    with pytest.raises(ValueError):
        prng.randint(keys, 4, [0], [2**31])
    with pytest.raises(ValueError):
        prng.prng_key(-1)
