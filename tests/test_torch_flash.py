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

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py and by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.flash import flash_attention_bshd as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models.flash import HUGE_WINDOW, flash_attention_bshd

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
