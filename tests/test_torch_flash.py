"""The port's long-prompt attention held against the reference:
``models/flash.py`` (KV-chunked online softmax with a recompute backward)
against ``repro.models.flash``, and kernel K4's plain version
``kernels/ref.py::flash_attention_ref`` (what ``kernels.ops.flash_attention``
runs for CPU tensors) against the reference's Pallas kernel
``repro.kernels.ops.flash_attention`` in interpret mode, on the same numpy
inputs.

Tolerances, those of the reference's own tests (tests/test_flash.py and
tests/test_kernels.py), and why:
* ``models/flash.py``: forward rtol = atol = 2e-5, gradients 1e-4, fp32.
  Both sides run the same operations in the same order; XLA and PyTorch sum
  the D- and key-contractions in different orders.
* K4's plain version: 2e-5 (rtol and atol) in fp32, 0.05 in bf16 (the two
  round the bf16 output of an fp32 softmax, and XLA's interpret-mode kernel
  walks blocks where the plain version is dense).

K4b's plain VJP (``ref.flash_attention_vjp_ref``, from the plain forward's
out and lse) is held against autograd of the dense route
(``layers._sdpa_dense`` on KV repeated to the query heads) at 1e-5 of each
gradient's largest magnitude, fp32: both sum the same products, over keys
or rows in another order. The training route's decisions
(``layers._takes_k4``) and its autograd Function on the plain versions run
here too.

The CUDA kernels themselves are held against the plain versions on the card
in tests/test_torch_cuda.py and by chip_smoke.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.flash import flash_attention_bshd as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.flash import HUGE_WINDOW, flash_attention_bshd
from repro_torch.utils import trace

torch.set_num_threads(1)


def _qkv(seed, B, Sq, H, D, Sk=None, Hk=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(dtype)
    k = rng.normal(size=(B, Sk or Sq, Hk or H, D)).astype(dtype)
    v = rng.normal(size=(B, Sk or Sq, Hk or H, D)).astype(dtype)
    return q, k, v


def _pos(lo, hi):
    p = np.arange(lo, hi, dtype=np.int32)
    return jnp.asarray(p), torch.from_numpy(p)


# --------------------------------------------------------------------------- #
# models/flash.py against repro.models.flash
# --------------------------------------------------------------------------- #

# (B, nblk, blk, H, D): the axes of tests/test_flash.py's forward sweep
FWD_CASES = [(1, 2, 32, 1, 16), (2, 4, 32, 4, 16), (1, 4, 64, 4, 64),
             (2, 2, 64, 1, 64), (2, 4, 64, 4, 16), (1, 2, 32, 4, 64)]


@pytest.mark.parametrize("B,nblk,blk,H,D", FWD_CASES)
def test_chunked_forward_matches_reference(B, nblk, blk, H, D):
    S = nblk * blk
    q, k, v = _qkv(S * H + D, B, S, H, D)
    jp, tp = _pos(0, S)
    want = jflash(*(jnp.asarray(a) for a in (q, k, v)), jp, jp, bq=blk,
                  bk=blk)
    got = flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                               tp, tp, bq=blk, bk=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 0.0), (0, 30.0),
                                            (48, 30.0)])
def test_chunked_grads_match_reference(window, softcap):
    """Gradients of sum(sin(out)) through the recompute backward."""
    B, S, H, D = 2, 128, 2, 32
    q, k, v = _qkv(window + int(softcap), B, S, H, D)
    jp, tp = _pos(0, S)

    def f(q, k, v):
        return jnp.sum(jnp.sin(jflash(q, k, v, jp, jp, window=window or None,
                                      softcap=softcap, bq=32, bk=32)))

    jout = jflash(*(jnp.asarray(a) for a in (q, k, v)), jp, jp,
                  window=window or None, softcap=softcap, bq=32, bk=32)
    jgrads = jax.grad(f, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_bshd(tq, tk, tv, tp, tp, window=window or None,
                               softcap=softcap, bq=32, bk=32)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_chunked_per_layer_windows_match_reference():
    """Per-layer windows, ints here where the reference traces them in its
    layer scan (the gemma3 local:global pattern): 16, then global."""
    B, S, H, D = 1, 64, 2, 16
    q, k, v = _qkv(0, B, S, H, D)
    jp, tp = _pos(0, S)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def per_layer(carry, win):
        o = jflash(jq, jk, jv, jp, jp, window=win, bq=32, bk=32)
        return carry, o

    _, want = jax.lax.scan(per_layer, 0, jnp.array([16, 2 ** 30], jnp.int32))
    for i, win in enumerate((16, HUGE_WINDOW)):
        got = flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                   tp, tp, window=win, bq=32, bk=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[i]),
                                   rtol=2e-5, atol=2e-5)


def test_chunked_kv_longer_than_q_matches_reference():
    """Sq = one block at the end of a longer KV (incremental prefill)."""
    B, H, D, Sq, Sk = 1, 2, 32, 64, 256
    q, k, v = _qkv(3, B, Sq, H, D, Sk=Sk)
    jqp, tqp = _pos(Sk - Sq, Sk)
    jkp, tkp = _pos(0, Sk)
    want = jflash(*(jnp.asarray(a) for a in (q, k, v)), jqp, jkp, bq=64,
                  bk=64)
    got = flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                               tqp, tkp, bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_chunked_ragged_length_raises():
    q, k, v = (torch.zeros((1, 48, 2, 8)) for _ in range(3))
    pos = torch.arange(48)
    with pytest.raises(ValueError, match="Sq % bq"):
        flash_attention_bshd(q, k, v, pos, pos, bq=32, bk=16)
    with pytest.raises(ValueError, match="Sk % bk"):
        flash_attention_bshd(q, k, v, pos, pos, bq=16, bk=32)


# --------------------------------------------------------------------------- #
# K4's plain version against the interpret-mode Pallas kernel
# --------------------------------------------------------------------------- #


def _k4_pair(q, k, v, **kw):
    """(port's ops.flash_attention on CPU, reference's Pallas kernel)."""
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    return got, np.asarray(want, np.float32)


# tests/test_kernels.py's sweep (MQA included), and a softcap case
@pytest.mark.parametrize("B,S,H,Hk,D,cap", [
    (1, 128, 2, 2, 64, 0.0),
    (2, 256, 4, 2, 64, 0.0),
    (2, 256, 8, 1, 32, 0.0),      # MQA
    (1, 512, 2, 2, 128, 0.0),
    (2, 256, 4, 2, 32, 30.0),     # softcap
])
def test_k4_plain_matches_pallas_kernel(B, S, H, Hk, D, cap):
    q, k, v = _qkv(S + H, B, S, H, D, Hk=Hk)
    got, want = _k4_pair(q, k, v, softcap=cap)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [16, 100])
def test_k4_plain_window_matches_pallas_kernel(window):
    q, k, v = _qkv(window, 2, 256, 2, 32)
    got, want = _k4_pair(q, k, v, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# gemma3's head dim: D = 256, beside a D of 160 that the kernel pads to it;
# with and without the window (the local layers' 1024 cut to the test's S)
@pytest.mark.parametrize("D,window,cap", [(256, 0, 0.0), (256, 64, 0.0),
                                          (256, 100, 30.0), (160, 0, 0.0),
                                          (160, 48, 0.0)])
def test_k4_plain_head_dim_256_matches_pallas_kernel(D, window, cap):
    """D up to 256, the TPU kernel's free head dim at gemma3's width: the
    port's ``ops.flash_attention`` (its contract shared with the plain
    version) raised ``ValueError`` above 128 before, where
    ``repro.kernels.ops.flash_attention`` computes. GQA 8/4 as gemma3's."""
    q, k, v = _qkv(D + window, 1, 256, 8, D, Hk=4)
    got, want = _k4_pair(q, k, v, window=window, softcap=cap)
    assert got.shape == (1, 256, 8, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_k4_plain_bf16_matches_pallas_kernel():
    q, k, v = _qkv(9, 1, 256, 2, 64)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .bfloat16() for a in (qb, kb, vb))
    got = ops.flash_attention(tq, tk, tv)
    want = jops.flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


def test_k4_plain_reads_kv_head_by_index():
    """Compact Hk-head K/V give what KV repeated to H heads gives (query
    head h reads kv head h // rep), and row 0 attends to key 0 alone."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 40, 6, 8, Hk=2))
    got = ref.flash_attention_ref(q, k, v)
    rep = [torch.repeat_interleave(t, 3, dim=2) for t in (k, v)]
    torch.testing.assert_close(got, ref.flash_attention_ref(q, *rep),
                               rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(got[:, 0], rep[1][:, 0], rtol=0, atol=0)


def test_k4_wrapper_raises_for_inputs_that_require_grad():
    """A leaf that requires grad raises, as does an output of a graph; the
    same computation under no_grad runs."""
    w = torch.ones((), requires_grad=True)
    q, k, v = (torch.zeros((1, 4, 2, 8)) for _ in range(3))
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(q, k, v * w)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v * w).shape == (1, 4, 2, 8)


def test_k4_wrapper_checks_its_arguments():
    q = torch.zeros((1, 4, 4, 8))
    kv = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, kv.double(), kv.double())
    with pytest.raises(ValueError, match="H % Hk"):
        ops.flash_attention(q, torch.zeros((1, 4, 3, 8)),
                            torch.zeros((1, 4, 3, 8)))
    with pytest.raises(ValueError, match="k and v"):
        ops.flash_attention(q, kv, torch.zeros((1, 5, 2, 8)))
    with pytest.raises(ValueError, match="D <= 256"):
        ops.flash_attention(*(torch.zeros((1, 4, 2, 257)) for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, kv, kv)


@pytest.mark.parametrize("case", ["bf16", "D 160", "cpu"])
def test_k4_training_instance_and_k4b_check_their_arguments(case):
    """K4's training instance and K4b take fp32 with D <= 128 (K4b: a
    multiple of 4) on CUDA tensors; the wrappers raise before a launch."""
    D = 160 if case == "D 160" else 64
    dt = torch.bfloat16 if case == "bf16" else torch.float32
    q = torch.zeros((1, 8, 2, D), dtype=dt)
    lse = torch.zeros((1, 2, 8))
    match = "CUDA tensors" if case == "cpu" else "fp32"
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_lse(q, q, q)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd(q, q, q, q.float(), lse, q.float())


# --------------------------------------------------------------------------- #
# K4b's plain VJP, the training route and its decisions
# --------------------------------------------------------------------------- #


def _dense_grads(q, k, v, dout, window=0, softcap=0.0):
    """(out, dq, dk, dv) by autograd of the dense route."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    out = layers._sdpa_dense(q, *layers._repeat_kv(k, v, rep), pos, pos,
                             window, softcap)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


def _close(got, want, rel=1e-5):
    tol = rel * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


# (B, S, H, Hk, D, window, softcap): D 64 and 128; rep 1, 7 and 16; S not
# a multiple of 64; a window and a softcap
VJP_CASES = [(2, 40, 2, 2, 64, 0, 0.0), (1, 70, 14, 2, 64, 0, 0.0),
             (1, 33, 16, 1, 128, 0, 0.0), (1, 65, 4, 2, 128, 0, 0.0),
             (2, 50, 4, 2, 64, 16, 0.0), (1, 45, 4, 1, 64, 0, 30.0)]


@pytest.mark.parametrize("B,S,H,Hk,D,window,cap", VJP_CASES)
def test_k4b_plain_vjp_matches_dense_autograd(B, S, H, Hk, D, window, cap):
    q, k, v = (torch.from_numpy(a) for a in _qkv(S + D, B, S, H, D, Hk=Hk))
    dout = torch.from_numpy(_qkv(S, B, S, H, D)[0])
    out, lse = ref.flash_attention_ref(q, k, v, window=window, softcap=cap,
                                       with_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    want = _dense_grads(q, k, v, dout, window, cap)
    _close(out, want[0])
    got = ref.flash_attention_vjp_ref(q, k, v, out, lse, dout, window=window,
                                      softcap=cap)
    for g, w, t in zip(got, want[1:], (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.float32
        _close(g, w)


def test_k4b_plain_vjp_magnitudes_bound_the_terms():
    """The magnitude VJP (the card tests' rounding scale) is at least the
    VJP's absolute value, element by element."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 48, 4, 64, Hk=2))
    dout = torch.from_numpy(_qkv(4, 1, 48, 4, 64)[0])
    out, lse = ref.flash_attention_ref(q, k, v, with_lse=True)
    val = ref.flash_attention_vjp_ref(q, k, v, out, lse, dout)
    mag = ref.flash_attention_vjp_ref(q, k, v, out, lse, dout,
                                      magnitudes=True)
    for g, m in zip(val, mag):
        assert bool((g.abs() <= m * (1 + 1e-5) + 1e-30).all())


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 30.0)])
def test_flash_attention_train_on_plain_versions(window, cap):
    """The autograd Function with the plain forward and VJP in the kernels'
    places: its out and its gradients are the dense route's."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 2, 70, 6, 64, Hk=2))
    dout = torch.from_numpy(_qkv(9, 2, 70, 6, 64)[0])
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention_train(
        qg, kg, vg, window=window, softcap=cap,
        fwd=lambda *a, **kw: ref.flash_attention_ref(*a, **kw, with_lse=True),
        vjp=ref.flash_attention_vjp_ref)
    got = torch.autograd.grad(out, (qg, kg, vg), dout)
    want = _dense_grads(q, k, v, dout, window, cap)
    _close(out.detach(), want[0])
    for g, w in zip(got, want[1:]):
        _close(g, w)


# (B, S, H, Hk, D, window, softcap): D 64 and 128, rep 7 and 16, a window,
# a softcap and both; S not a multiple of 64
JAX_VJP_CASES = [(1, 70, 14, 2, 64, 0, 0.0), (1, 33, 16, 1, 128, 0, 0.0),
                 (2, 50, 14, 2, 64, 16, 0.0), (1, 45, 7, 1, 64, 0, 30.0),
                 (1, 40, 16, 1, 128, 12, 30.0)]


@pytest.mark.parametrize("B,S,H,Hk,D,window,cap", JAX_VJP_CASES)
def test_k4b_plain_vjp_matches_reference_grads(B, S, H, Hk, D, window, cap):
    """K4b's plain VJP against ``jax.vjp`` of the reference's attention
    (``repro.models.flash.flash_attention_bshd``, KV repeated to the query
    heads inside the function, so dk and dv sum each kv head's rep query
    heads) on the same inputs and cotangent, at the gradient tolerance of
    the chunked route's test (rtol = atol = 1e-4)."""
    q, k, v = _qkv(S + D + H, B, S, H, D, Hk=Hk)
    dout = _qkv(S + 1, B, S, H, D)[0]
    jp, _ = _pos(0, S)
    rep = H // Hk

    def f(q, k, v):
        return jflash(q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
                      jp, jp, window=window or None, softcap=cap, bq=S, bk=S)

    _, pull = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = pull(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = ref.flash_attention_ref(tq, tk, tv, window=window, softcap=cap,
                                       with_lse=True)
    got = ref.flash_attention_vjp_ref(tq, tk, tv, out, lse,
                                      torch.from_numpy(dout), window=window,
                                      softcap=cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 30.0)])
def test_flash_attention_train_second_order_matches_dense(window, cap):
    """A differentiated backward (``create_graph``, as the Hessian-vector
    products of ``core/preconditioner.py`` take it) through the autograd
    Function: the gradient of ⟨g, w⟩ in q, k and v is the dense route's,
    at 1e-5 of its largest magnitude (the first-order tolerance above)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, 1, 40, 4, 64, Hk=2))
    dout = torch.from_numpy(_qkv(11, 1, 40, 4, 64)[0])
    probe = [torch.from_numpy(a) for a in _qkv(12, 1, 40, 4, 64, Hk=2)]
    rep = 2
    pos = torch.arange(40, dtype=torch.int32)

    def hvp(attend):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attend(*xs)
        g = torch.autograd.grad((out * dout).sum(), xs, create_graph=True)
        return torch.autograd.grad(sum((gi * pi).sum()
                                       for gi, pi in zip(g, probe)), xs)

    got = hvp(lambda q, k, v: fa.flash_attention_train(
        q, k, v, window=window, softcap=cap,
        fwd=lambda *a, **kw: ref.flash_attention_ref(*a, **kw, with_lse=True),
        vjp=ref.flash_attention_vjp_ref))
    want = hvp(lambda q, k, v: layers._sdpa_dense(
        q, *layers._repeat_kv(k, v, rep), pos, pos, window, cap))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("B,S,H,Hk,D,window", [(4, 1024, 14, 2, 64, 0),
                                               (2, 4096, 32, 2, 128, 0),
                                               (2, 1000, 8, 2, 80, 300)])
def test_k4_operators_fake_kernels_and_flops(B, S, H, Hk, D, window):
    """K4's training instance and K4b under ``FakeTensorMode`` on fake CUDA
    tensors (no card): the outputs' shapes, and ``FlopCounterMode`` and the
    dry run's ``CostMode`` count 4·D and 10·D flops a kept pair
    (``fa.work``, ``fa.work_bwd``); the cells' calls: 7.52 and 18.81 GFLOP
    (qwen2) and 275.0 and 687.4 GFLOP (nemotron)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.utils import cost
    kept = B * H * sum(min(r + 1, window or S) for r in range(S))
    assert fa.pairs(B, S, H, window) == kept
    with FakeTensorMode():
        q = torch.empty((B, S, H, D), device="cuda")
        kv = torch.empty((B, S, Hk, D), device="cuda")
        with FlopCounterMode(display=False) as fc:
            out, lse = fa.flash_attention_lse(q, kv, kv, window=window)
            fwd = fc.get_total_flops()
            grads = fa.flash_attention_bwd(q, kv, kv, out, lse, out,
                                           window=window)
        mode = cost.CostMode(node_ranks=8)
        with mode:
            fa.flash_attention_bwd(q, kv, kv, out, lse, out, window=window)
    assert out.shape == (B, S, H, D) and lse.shape == (B, H, S)
    assert [tuple(t.shape) for t in grads] == [(B, S, H, D), (B, S, Hk, D),
                                               (B, S, Hk, D)]
    assert fwd == 4 * D * kept == fa.work(B, S, H, Hk, D, window)[0]
    assert fc.get_total_flops() - fwd == 10 * D * kept
    totals = mode.totals()
    assert totals["flops:float32"] == fa.work_bwd(B, S, H, Hk, D, window)[0]
    assert totals["bytes"] == fa.work_bwd(B, S, H, Hk, D, window)[1]
    if (B, S, D) == (4, 1024, 64):
        assert round(fwd / 1e7) == 752 and round(10 * D * kept / 1e7) == 1881


def _stand_in(D=64, dtype=torch.float32, grad=True):
    """What ``_takes_k4`` reads of a CUDA tensor, without a card."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=grad,
                                 shape=(2, 64, 4, D), dtype=dtype)


@pytest.mark.parametrize("case,want", [
    ("cuda D 64", True), ("cuda D 128", True), ("cuda D 80", True),
    ("cpu", False), ("no grad", False), ("nothing requires grad", False),
    ("fake cuda", True), ("fake cpu", False), ("D 256", False),
    ("D 132", False), ("D 66", False), ("bf16", False)])
def test_takes_k4_decisions(case, want):
    """A differentiated fp32 call on CUDA tensors at a D K4b takes goes to
    K4 + K4b, fake ones too (the dry run on a CUDA build: the operators'
    fake kernels); the CPU (fake or not), no-grad calls, a D past 128 or
    not a multiple of 4 and bf16 keep today's routes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if case == "cpu":
        t = torch.zeros((1, 8, 2, 64), requires_grad=True)
        assert layers._takes_k4(t, t, t) is want
        return
    if case.startswith("fake"):
        with FakeTensorMode():
            t = torch.empty((1, 8, 2, 64),
                            device=case.split()[1]).requires_grad_()
            assert layers._takes_k4(t, t, t) is want
        return
    D = {"cuda D 128": 128, "cuda D 80": 80, "D 256": 256, "D 132": 132,
         "D 66": 66}.get(case, 64)
    t = _stand_in(D, torch.bfloat16 if case == "bf16" else torch.float32,
                  grad=case != "nothing requires grad")
    if case == "no grad":
        with torch.no_grad():
            assert layers._takes_k4(t, t, t) is want
        return
    assert layers._takes_k4(t, t, t) is want


@pytest.mark.parametrize("B,S,Hk,rep,want", [(4, 1024, 2, 7, 7),
                                             (2, 4096, 2, 16, 4),
                                             (1, 64, 1, 7, 7),
                                             (8, 4096, 8, 4, 1)])
def test_k4b_splits(B, S, Hk, rep, want):
    """The dk/dv launch's splits of the rep heads: the smallest divisor of
    rep that reaches the block target (the cells' shapes: 7 and 4)."""
    ns = fa.bwd_splits(B, S, Hk, rep)
    assert ns == want and rep % ns == 0


def test_attention_route_counts_attn_k4(monkeypatch):
    """With ``_takes_k4`` true, ``layers.attention`` runs
    ``flash_attention_train`` inside the ``model.attention`` span and counts
    ``model.attn_k4`` once a call; on the plain versions its parameter
    gradients are the dense route's."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(gen, cfg)
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    pos = torch.arange(40, dtype=torch.int32)
    plain = fa.flash_attention_train

    def grads(route):
        monkeypatch.setattr(layers, "_takes_k4", lambda *t: route)
        monkeypatch.setattr(fa, "flash_attention_train", lambda *a, **kw: plain(
            *a, **kw, fwd=lambda *b, **c: ref.flash_attention_ref(
                *b, **c, with_lse=True), vjp=ref.flash_attention_vjp_ref))
        leaves = [p["wq"]["w"], p["wk"]["w"], p["wv"]["w"]]
        w = [t.clone().requires_grad_() for t in leaves]
        pp = dict(p, wq=dict(p["wq"], w=w[0]), wk=dict(p["wk"], w=w[1]),
                  wv=dict(p["wv"], w=w[2]))
        with trace.recording() as rec:
            out, _ = layers.attention(pp, cfg, x, pos, layers.AttnCall(),
                                      torch.float32)
            g = torch.autograd.grad(out.square().sum(), w)
        return g, rec.collect()[1]

    got, counters = grads(True)
    assert sum(c.get("model.attn_k4", 0) for c in counters.values()) == 1
    want, counters = grads(False)
    assert all("model.attn_k4" not in c for c in counters.values())
    for u, v in zip(got, want):
        _close(u, v)
