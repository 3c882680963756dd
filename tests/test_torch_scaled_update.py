"""Kernel K2 of the port (the legacy per-leaf scaled step) held against the
reference.

On the CPU, ``repro_torch.kernels.ops.scaled_update`` runs K2's plain
version ``ref.scaled_update_ref``; it is compared with the reference's
Pallas kernel run in interpret mode (``repro.kernels.ops.scaled_update``)
and with its jitted jnp oracle ``repro.kernels.ref.scaled_update_ref``, on
the same numpy inputs, over ragged n, both magnitudes (√d and |d|), β₁ ∈ {0,
0.9} and a d that holds zeros and values under α² (the clip is hit).

Tolerance: 4 fp32 ulp of the largest magnitude in each output, the argument
of tests/test_torch_kernels.py. Under XLA's CPU backend both reference sides
compute m' = β₁m + g as one FMA (every element of m' equals fma(β₁, m, g)),
where the port rounds β₁m and then the sum, as its CUDA kernel does; one
such rounding is an ulp of the operands, which shows as many ulps of an m'
that cancels towards 0. bf16 inputs are held to one bf16 ulp of each
output's largest magnitude (the fp32 results, within 4 fp32 ulp, may round
to neighbouring bf16 values). The CUDA kernel itself is held bitwise against
the plain version on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scaled_update as su
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ULP_TOL = 4 * np.finfo(np.float32).eps
BF16_TOL = 2.0 ** -8
NS = [1, 17, 127, 128, 129, 4096, 16384, 16385, 300001]
ALPHA = 1e-2


def _inputs(n, seed=0, shape=None):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    d = np.abs(rng.normal(size=n)).astype(np.float32)
    d[::5] = 0.0                              # D̂ = α
    d[1::7] = 0.25 * ALPHA ** 2               # under α²: the clip is hit
    out = (p, m, g, d)
    return tuple(x.reshape(shape) for x in out) if shape else out


def _close(got, want, tol=ULP_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


_jref = jax.jit(jref.scaled_update_ref,
                static_argnames=("gamma", "beta1", "alpha", "squared"))


@pytest.mark.parametrize("n", NS)
def test_k2_plain_matches_reference(n):
    """Both magnitudes and both β₁ at each n: the port's plain version
    against the interpret-mode Pallas kernel and the jitted jnp oracle."""
    x = _inputs(n, seed=n)
    for squared in (True, False):
        for beta1 in (0.0, 0.9):
            kw = dict(gamma=0.05, beta1=beta1, alpha=ALPHA, squared=squared)
            got = ops.scaled_update(*(torch.from_numpy(a) for a in x), **kw)
            want_k = jops.scaled_update(*(jnp.asarray(a) for a in x), **kw)
            want_r = _jref(*(jnp.asarray(a) for a in x), **kw)
            for g, wk, wr in zip(got, want_k, want_r):
                _close(g.numpy(), wk)
                _close(g.numpy(), wr)


def test_k2_reference_contracts_but_the_port_does_not():
    """The reference's m' is fma(β₁, m, g) on this CPU backend; the port's
    is the twice-rounded β₁m + g, as its kernel's (-fmad=false)."""
    p, m, g, d = _inputs(16385, seed=3)
    kw = dict(gamma=0.05, beta1=0.9, alpha=ALPHA, squared=True)
    _, mt = ops.scaled_update(*(torch.from_numpy(a) for a in (p, m, g, d)),
                              **kw)
    twice = (np.float32(0.9) * m).astype(np.float32) + g
    np.testing.assert_array_equal(mt.numpy(), twice)
    _, mk = jops.scaled_update(*(jnp.asarray(a) for a in (p, m, g, d)), **kw)
    fma = (np.float64(np.float32(0.9)) * m.astype(np.float64)
           + g.astype(np.float64)).astype(np.float32)
    assert np.mean(np.asarray(mk) == fma) > 0.999


def test_k2_shapes_and_nan():
    """Any shape is flattened and comes back in p's shape; a negative d
    under √ gives NaN that the max passes through, as ``jnp.maximum``."""
    x = _inputs(6 * 35, seed=1, shape=(6, 5, 7))
    x[3][0, 0, :3] = -1.0
    kw = dict(gamma=0.1, beta1=0.9, alpha=ALPHA, squared=True)
    po, mo = ops.scaled_update(*(torch.from_numpy(a) for a in x), **kw)
    wp, wm = jops.scaled_update(*(jnp.asarray(a) for a in x), **kw)
    assert po.shape == (6, 5, 7) and mo.shape == (6, 5, 7)
    assert torch.isnan(po[0, 0, :3]).all()
    assert np.isnan(np.asarray(wp)[0, 0, :3]).all()
    fin = ~np.isnan(np.asarray(wp))
    _close(po.numpy()[fin], np.asarray(wp)[fin])
    _close(mo.numpy(), wm)


@pytest.mark.parametrize("n", [129, 16385])
def test_k2_bf16_inputs(n):
    """bf16 leaves are cast to fp32, stepped, and cast back to their
    dtypes, as the reference's op does."""
    x = _inputs(n, seed=7)
    xb = [jnp.asarray(a).astype(jnp.bfloat16) for a in x]
    xt = [torch.from_numpy(a).to(torch.bfloat16) for a in x]
    kw = dict(gamma=0.05, beta1=0.9, alpha=ALPHA, squared=True)
    po, mo = ops.scaled_update(*xt, **kw)
    wp, wm = jops.scaled_update(*xb, **kw)
    assert po.dtype == mo.dtype == torch.bfloat16
    for g, w in zip((po, mo), (wp, wm)):
        _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
               BF16_TOL)


def _mlp_trees(M=10, seed=0):
    """Per-client MLP trees (the Fig. 1 model's leaves with a client dim):
    params, momentum and a local D."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (192, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)}
    mk = lambda f: {k: f((M,) + s).astype(np.float32)
                    for k, s in shapes.items()}
    params = mk(lambda s: rng.normal(size=s))
    mom = mk(lambda s: rng.normal(size=s))
    d = mk(lambda s: np.abs(rng.normal(size=s)) * 1e-3)
    return params, mom, d


@pytest.mark.parametrize("squared", [True, False])
def test_k2_tree_matches_reference(squared):
    """``scaled_update_tree`` on the MLP tree, every leaf one K2 step with
    zeros in the momentum slot and β₁ = 0, against the reference's."""
    params, mom, d = _mlp_trees()
    to_t = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
    to_j = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    got = ops.scaled_update_tree(to_t(params), to_t(mom), to_t(d), 0.002,
                                 ALPHA, squared=squared)
    want = jops.scaled_update_tree(to_j(params), to_j(mom), to_j(d), 0.002,
                                   ALPHA, squared=squared)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k])
    # no FMA on either side here (β₁ = 0): p − (γ·m)/D̂ agrees bitwise with
    # the plain version's own leaf call
    leaf = ref.scaled_update_ref(to_t(params)["w2"].reshape(-1),
                                 torch.zeros(12800),
                                 to_t(mom)["w2"].reshape(-1),
                                 to_t(d)["w2"].reshape(-1), gamma=0.002,
                                 beta1=0.0, alpha=ALPHA, squared=squared)[0]
    assert torch.equal(got["w2"].reshape(-1), leaf)
    assert len(tree_leaves(got)) == 4


def test_k2_signed_zeros_as_the_reference():
    """With zeros in the momentum slot, β₁ = 0 and g = ±0, p' keeps p's
    signed zero on both sides."""
    z = np.array([0.0, -0.0, -0.0, 0.0], np.float32)
    p = np.array([-0.0, 0.0, -0.0, 1.0], np.float32)
    d = np.ones(4, np.float32)
    kw = dict(gamma=0.1, beta1=0.0, alpha=ALPHA, squared=True)
    po, mo = ops.scaled_update(*(torch.from_numpy(a) for a in (p, z, z, d)),
                               **kw)
    wp, wm = jops.scaled_update(*(jnp.asarray(a) for a in (p, z, z, d)),
                                **kw)
    np.testing.assert_array_equal(np.signbit(po.numpy()),
                                  np.signbit(np.asarray(wp)))
    np.testing.assert_array_equal(np.signbit(mo.numpy()),
                                  np.signbit(np.asarray(wm)))


@pytest.mark.parametrize("bad", ["dtype", "length", "strided", "empty",
                                 "device"])
def test_k2_contract_raises(bad):
    x = [torch.from_numpy(a) for a in _inputs(64)]
    kw = dict(gamma=0.1, beta1=0.9, alpha=ALPHA)
    if bad == "dtype":
        x[2] = x[2].double()
    elif bad == "length":
        x[3] = x[3][:63]
    elif bad == "strided":
        x[1] = torch.zeros(128)[::2]
    elif bad == "empty":
        x = [a[:0] for a in x]
    else:
        x[3] = x[3].to("meta")
    with pytest.raises(ValueError):
        su.check_flat_args(*x)
    if bad in ("length", "empty", "device"):
        with pytest.raises((ValueError, RuntimeError)):
            ops.scaled_update(*x, **kw)


def test_k2_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The kernel wrapper launches only on CUDA tensors; ``ops`` runs the
    plain version for CPU tensors, and no launch is counted for either."""
    before = su.scaled_update_flat.launches
    x = [torch.from_numpy(a) for a in _inputs(100)]
    with pytest.raises(ValueError, match="launches on CUDA tensors"):
        su.scaled_update_flat(*x, gamma=0.1, beta1=0.9, alpha=ALPHA)
    ops.scaled_update(*x, gamma=0.1, beta1=0.9, alpha=ALPHA)
    ops.scaled_update_tree({"a": x[0]}, {"a": x[1]}, {"a": x[3]}, 0.1, ALPHA)
    assert su.scaled_update_flat.launches == before
