"""The port's rng interface (``repro_torch.utils.rng``) and the test-side
stream that replays the reference's ``jax.random`` draws through it
(``tests/_torch_rng_replay.py``).

Everything here is exact: keys and integer draws are compared with equality,
float draws bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rng_replay import JaxStream
from repro_torch.launch import train
from repro_torch.utils import rng

torch.set_num_threads(1)


def _key_data(stream):
    return np.asarray(jax.random.key_data(stream.key)) \
        if jax.dtypes.issubdtype(stream.key.dtype, jax.dtypes.prng_key) \
        else np.asarray(stream.key)


@pytest.mark.parametrize("H,M", [(1, 1), (2, 2), (3, 4), (4, 3)])
def test_split_of_shape_is_row_major_split(H, M):
    """The per-step streams rest on split(key, (H, M)) == split(key, H·M)
    laid out row-major, on the installed jax."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    shaped = np.asarray(jax.random.split(key, (H, M)))
    flat = np.asarray(jax.random.split(key, H * M))
    np.testing.assert_array_equal(shaped.reshape(H * M, -1), flat)
    steps = rng.step_streams(JaxStream(key), H, M)
    assert len(steps) == H and all(len(row) == M for row in steps)
    for h in range(H):
        for m in range(M):
            np.testing.assert_array_equal(_key_data(steps[h][m]),
                                          shaped[h, m])


def test_replay_stream_draws_are_the_reference_draws():
    key = jax.random.PRNGKey(3)
    st = JaxStream(key)
    k17 = jax.random.fold_in(key, 17)
    leaf_keys = jax.random.split(k17, 3)
    for i, child in enumerate(st.fold(17).split(3)):
        np.testing.assert_array_equal(
            child.uniform((2, 5), "cpu").numpy(),
            np.asarray(jax.random.uniform(leaf_keys[i], (2, 5))))
        np.testing.assert_array_equal(
            child.rademacher((7,), "cpu").numpy(),
            np.asarray(jax.random.rademacher(leaf_keys[i], (7,),
                                             np.float32)))
    perm = st.fold(3).permutation(6)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jax.random.permutation(
            jax.random.fold_in(key, 3), 6)))


def test_fold_constants_are_the_reference_constants():
    from repro.core import objectives as jobj
    assert (rng.PARTICIPATION_FOLD, rng.HUTCHINSON_FOLD, rng.OBJECTIVE_FOLD,
            rng.COMPRESSION_FOLD) == (3, 7, 11, 17)
    assert rng.OBJECTIVE_FOLD == jobj._OBJECTIVE_FOLD


def _draws(stream):
    return (stream.uniform((3, 4), "cpu"), stream.rademacher((16,), "cpu"),
            stream.permutation(9))


@pytest.mark.parametrize("path", [(), ("fold", 3), ("split", 4, 2),
                                  ("fold", 17, "split", 5, 4)])
def test_torch_stream_is_addressed_by_seed_and_path(path):
    """The same (seed, path) gives the same draws whatever was drawn before
    and however the stream object was reached (round-addressable)."""
    def walk(st):
        it = iter(path)
        for op in it:
            st = st.fold(next(it)) if op == "fold" \
                else st.split(next(it))[next(it)]
        return st
    a = walk(rng.TorchStream(11))
    torch.rand(100)                       # global rng state plays no part
    _draws(rng.TorchStream(11).fold(99))  # nor do draws from other streams
    b = walk(rng.TorchStream(11))
    for x, y in zip(_draws(a), _draws(b)):
        assert torch.equal(x, y)
    other = walk(rng.TorchStream(12))
    assert not torch.equal(_draws(a)[0], _draws(other)[0])


def test_torch_stream_children_differ():
    root = rng.TorchStream(0)
    kids = root.split(4) + [root.fold(3), root.fold(7), root]
    firsts = [k.uniform((8,), "cpu") for k in kids]
    for i in range(len(firsts)):
        for j in range(i + 1, len(firsts)):
            assert not torch.equal(firsts[i], firsts[j]), (i, j)


def test_torch_stream_draw_contracts():
    st = rng.TorchStream(4).fold(1)
    u = st.uniform((1000,), "cpu")
    assert u.dtype == torch.float32 and u.shape == (1000,)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    r = st.rademacher((2000,), "cpu")
    assert r.dtype == torch.float32
    assert set(r.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(r.mean())) < 0.1
    p = st.permutation(50)
    assert p.dtype == torch.int64
    assert sorted(p.tolist()) == list(range(50))


def test_train_round_r_draws_from_fold_r_of_seed_plus_one():
    """Round r of a run draws from TorchStream(seed + 1).fold(r), as the
    reference keys round r with fold_in(PRNGKey(seed + 1), r)."""
    run = train.setup(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                       "--seed", "3"])
    for r in (0, 1, 5):
        assert torch.equal(run.stream(r).uniform((4,), "cpu"),
                           rng.TorchStream(4).fold(r).uniform((4,), "cpu"))
    key = jax.random.PRNGKey(4)
    replay = train.setup(["--arch", "qwen2-0.5b", "--reduced", "--device",
                          "cpu", "--seed", "3"], root_stream=JaxStream(key))
    np.testing.assert_array_equal(_key_data(replay.stream(2)),
                                  np.asarray(jax.random.fold_in(key, 2)))


def test_replay_stream_gumbel_is_the_reference_gumbel():
    """JaxStream.gumbel replays jax.random.gumbel bitwise, also along the
    serve noise chain ``key, k = split(key)`` (``nxt, draw = split(2)``)."""
    key = jax.random.PRNGKey(2)
    st = JaxStream(key)
    for _ in range(3):
        key, k = jax.random.split(key)
        st, draw = st.split(2)
        np.testing.assert_array_equal(
            draw.gumbel((2, 7), "cpu").numpy(),
            np.asarray(jax.random.gumbel(k, (2, 7), jnp.float32)))
        np.testing.assert_array_equal(_key_data(st), np.asarray(key))


def test_torch_stream_gumbel_is_addressed_and_finite_at_the_edges():
    a = rng.TorchStream(5).fold(2).split(2)[1].gumbel((4000,), "cpu")
    torch.rand(10)
    b = rng.TorchStream(5).fold(2).split(2)[1].gumbel((4000,), "cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, rng.TorchStream(5).fold(2).split(2)[0]
                           .gumbel((4000,), "cpu"))
    assert bool(torch.isfinite(a).all())
    assert abs(float(a.mean()) - 0.5772) < 0.1      # Euler–Mascheroni
    edges = rng.gumbel_from_uniform(
        torch.tensor([0.0, torch.finfo(torch.float32).tiny, 0.5,
                      1.0 - 2.0 ** -24]))
    assert bool(torch.isfinite(edges).all())
    # u = 0 is raised to tiny, the bottom of the reference's [tiny, 1)
    assert float(edges[0]) == float(edges[1])
    np.testing.assert_allclose(edges.numpy(),
                               [-4.4698, -4.4698, 0.3665, 16.6355],
                               atol=1e-4)
