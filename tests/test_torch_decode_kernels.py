"""Kernels K5 (decode attention) and K6 (fused unembed + argmax) of the port
held against the reference.

On the CPU the port's wrappers ``repro_torch.kernels.ops.decode_attention``
and ``decode_sample`` run the plain versions in ``kernels/ref.py``; they are
compared with the reference's Pallas kernels in interpret mode
(``repro.kernels.ops``) and with its jnp oracles (``repro.kernels.ref``), on
the same numpy inputs.

Tolerances:
* K5: rtol 1e-5, atol 1e-6 in fp32. Both sides run the same operations in
  the same order, but XLA and PyTorch sum the D- and C-contractions in
  different orders, so bitwise agreement is not claimed.
* K6: token ids under the near-tie rule (``ref.near_tie_check``): with ℓ
  the port's plain logits and τ = 1e-5·(1 + max|ℓ|), ids must be equal
  where the top-2 gap of ℓ is > τ, and the chosen id's ℓ must be within τ
  of the max where it is not; the exceptions are counted and must be few.
  Exact cases (duplicated rows, masked padded ids) are held exactly.

The CUDA kernels themselves are held against the plain versions on the card
in tests/test_torch_cuda.py and by chip_smoke.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _bf16(a):
    """numpy fp32 -> (jnp bf16 array, torch bf16 tensor) with equal bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()) \
        .view(torch.bfloat16)
    return j, t


def _k5_inputs(B, H, Hk, C, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, C, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Hk, D)).astype(np.float32)
    # causal at a random position per row, plus random masked holes; the
    # current position is always valid
    pos = rng.integers(0, C, size=B)
    ok = (np.arange(C)[None] <= pos[:, None]) \
        & (rng.random((B, C)) > 0.25)
    ok[np.arange(B), pos] = True
    bias = np.where(ok, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("C", [1, 7, 64])
@pytest.mark.parametrize("H,Hk", [(4, 2), (14, 2)])
@pytest.mark.parametrize("B", [1, 3])
def test_k5_plain_matches_reference(B, H, Hk, C, cap):
    D = 64
    q, k, v, bias = _k5_inputs(B, H, Hk, C, D, seed=B * 1000 + H * 10 + C)
    kj, kt = _bf16(k)
    vj, vt = _bf16(v)
    got = ops.decode_attention(torch.from_numpy(q), kt, vt,
                               torch.from_numpy(bias), softcap=cap)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    interp = np.asarray(jops.decode_attention(jnp.asarray(q), kj, vj,
                                              jnp.asarray(bias), softcap=cap))
    oracle = np.asarray(jref.decode_attention_ref(jnp.asarray(q), kj, vj,
                                                  jnp.asarray(bias),
                                                  softcap=cap))
    np.testing.assert_allclose(got.numpy(), interp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("D", [256, 160])
def test_k5_plain_head_dim_256_matches_reference(D, window):
    """D up to 256 (gemma3's d_head; rep 2 of GQA 8/4), with a sliding
    window in the bias where ``window`` > 0: the port's
    ``ops.decode_attention`` raised ``ValueError`` above 128 before (its
    contract is shared with the plain version), where the reference's
    interpret-mode kernel computes."""
    B, H, Hk, C = 2, 8, 4, 97
    q, k, v, bias = _k5_inputs(B, H, Hk, C, D, seed=D + window)
    if window:
        pos = np.arange(C)
        last = np.where(bias > -1, pos[None], -1).max(1)   # the query row
        bias[(last[:, None] - pos[None]) >= window] = -1e30
    kj, kt = _bf16(k)
    vj, vt = _bf16(v)
    got = ops.decode_attention(torch.from_numpy(q), kt, vt,
                               torch.from_numpy(bias), softcap=30.0)
    assert got.shape == (B, H, D)
    interp = np.asarray(jops.decode_attention(jnp.asarray(q), kj, vj,
                                              jnp.asarray(bias),
                                              softcap=30.0))
    np.testing.assert_allclose(got.numpy(), interp, rtol=RTOL, atol=ATOL)


def test_k5_masked_positions_weigh_exactly_zero():
    """Whatever k and v hold at masked positions, the output is bitwise the
    same: exp(-1e30 - max) is +0 in fp32."""
    q, k, v, bias = _k5_inputs(3, 14, 2, 33, 64, seed=5)
    bias[:, :] = -1e30
    bias[:, 7] = 0.0                              # one valid position per row
    args = [torch.from_numpy(q), _bf16(k)[1], _bf16(v)[1],
            torch.from_numpy(bias)]
    a = ops.decode_attention(*args)
    k2, v2 = k * 1e3, -v * 1e3
    k2[:, 7], v2[:, 7] = k[:, 7], v[:, 7]
    b = ops.decode_attention(args[0], _bf16(k2)[1], _bf16(v2)[1], args[3])
    assert torch.equal(a, b)
    # one valid position: the output is that position's v (rounded to bf16)
    want = args[2][:, 7].float().repeat_interleave(7, dim=1)
    assert torch.equal(a, want)


@pytest.mark.parametrize("bad", ["q_dtype", "k_dtype", "bias_shape",
                                 "noncontig", "rep", "mixed", "wide_rep",
                                 "wide"])
def test_k5_contract_raises(bad):
    q, k, v, bias = _k5_inputs(2, 4, 2, 8, 64, seed=1)
    q, bias = torch.from_numpy(q), torch.from_numpy(bias)
    k, v = _bf16(k)[1], _bf16(v)[1]
    if bad == "q_dtype":
        q = q.double()
    elif bad == "k_dtype":
        k = k.float()
    elif bad == "bias_shape":
        bias = bias[:, :4].contiguous()
    elif bad == "noncontig":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rep":
        q = torch.zeros((2, 34, 64))              # rep 17 > 16
    elif bad == "mixed":
        q = q.to("meta")
    elif bad == "wide_rep":     # rep 9 > 8 holds 4 head dims a lane: D <= 128
        q = torch.zeros((2, 18, 256))
        k = torch.zeros((2, 8, 2, 256), dtype=torch.bfloat16)
    elif bad == "wide":         # D > 256
        q = torch.zeros((2, 4, 264))
        k = v = torch.zeros((2, 8, 2, 264), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v, bias)


@pytest.mark.parametrize("B,Hk,C", [(8, 2, 576), (2, 2, 8224), (1, 1, 1),
                                    (1, 1, 32), (1, 1, 33), (3, 2, 4099),
                                    (8, 2, 1), (64, 8, 100), (1, 1, 32768),
                                    (2, 4, 129), (512, 1, 5000)])
def test_k5_attention_plan_covers_c(B, Hk, C):
    """K5's split plan: whole 32-position tiles but the last split, which
    is never empty; C covered exactly; C <= 32 gives one split; the grid
    within one split a (b, g) of TARGET_BLOCKS."""
    split, splits = ds.attention_plan(B, Hk, C)
    assert split % ds.SPLIT_GRAIN == 0 and split >= ds.SPLIT_GRAIN
    assert (splits - 1) * split < C <= splits * split
    assert 1 <= splits <= 65535
    if C <= ds.SPLIT_GRAIN:
        assert splits == 1
    if splits > 1:
        assert B * Hk * (splits - 1) < ds.TARGET_BLOCKS


def test_k5_attention_plan_at_the_path_shapes():
    """The serve path (B=8, Hk=2, C=576) and the long prompt (B=2, C=8224):
    144 and 260 blocks."""
    assert ds.attention_plan(8, 2, 576) == (64, 9)
    assert ds.attention_plan(2, 2, 8224) == (128, 65)
    assert 16 * 9 == 144 and 4 * 65 == 260


def test_library_path_hashes_csrc_headers(tmp_path, monkeypatch):
    """A kernel library's name changes with its source and with any header
    in csrc/ (decode_attention.cu and flash_attention.cu include
    smem_once.cuh), so an edited header rebuilds them."""
    from repro_torch.kernels import build
    assert os.path.exists(os.path.join(build.CSRC, "smem_once.cuh"))
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("a.cu")
    assert build.library_path("a.cu") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("a.cu")
    assert second != first
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("a.cu") not in (first, second)


def _k5_split_bias(B, C, split, mode, seed):
    """(B, C) fp32 mask: random causal holes ("holes"); one valid position
    in the first, a middle or the last split ("first", "middle", "last");
    or valid positions in one split only, every other split wholly masked
    ("one_split")."""
    rng = np.random.default_rng(seed)
    splits = -(-C // split)
    ok = np.zeros((B, C), bool)
    if mode == "holes":
        ok = rng.random((B, C)) > 0.5
        ok[:, rng.integers(0, C)] = True
    elif mode == "one_split":
        s = splits // 2
        lo, hi = s * split, min(C, (s + 1) * split)
        ok[:, lo:hi] = rng.random((B, hi - lo)) > 0.3
        ok[:, lo] = True
    else:
        s = {"first": 0, "middle": splits // 2, "last": splits - 1}[mode]
        ok[:, min(C - 1, s * split + rng.integers(0, split))] = True
    return np.where(ok, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("mode", ["holes", "first", "middle", "last",
                                  "one_split"])
@pytest.mark.parametrize("C,split", [(1, 32), (7, 32), (31, 32), (32, 32),
                                     (33, 32), (97, 32), (25, 8)])
def test_k5_split_merge_matches_plain_and_reference(C, split, mode, cap):
    """K5's two-pass arithmetic (``ref.decode_attention_split_ref``) against
    its one-pass plain version and the reference's interpret-mode Pallas
    kernel, with C at 1, 7, split - 1, split, split + 1, 3·split + 1 and
    wholly masked splits. Tolerance rtol 1e-5, atol 1e-6 as for K5: the
    merge reorders the sums, e^(m_s - m*) of a wholly masked split is +0."""
    B, H, Hk, D = 2, 14, 2, 64
    q, k, v, _ = _k5_inputs(B, H, Hk, C, D, seed=C * 10 + split)
    bias = _k5_split_bias(B, C, split, mode, seed=C + split)
    kj, kt = _bf16(k)
    vj, vt = _bf16(v)
    qt, bt = torch.from_numpy(q), torch.from_numpy(bias)
    got = ref.decode_attention_split_ref(qt, kt, vt, bt, split=split,
                                         softcap=cap)
    assert got.shape == (B, H, D) and bool(torch.isfinite(got).all())
    plain = ref.decode_attention_ref(qt, kt, vt, bt, softcap=cap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    interp = np.asarray(jops.decode_attention(jnp.asarray(q), kj, vj,
                                              jnp.asarray(bias), softcap=cap))
    np.testing.assert_allclose(got.numpy(), interp, rtol=RTOL, atol=ATOL)


def test_k5_split_merge_at_the_long_prompt_plan():
    """The long prompt's plan (splits of 128) on a reduced slot count:
    C = 3·128 + 1 with one valid position in the last, one-position
    split."""
    B, H, Hk, D, C = 1, 14, 2, 64, 3 * 128 + 1
    q, k, v, _ = _k5_inputs(B, H, Hk, C, D, seed=17)
    bias = np.full((B, C), -1e30, np.float32)
    bias[:, C - 1] = 0.0
    args = [torch.from_numpy(q), _bf16(k)[1], _bf16(v)[1],
            torch.from_numpy(bias)]
    got = ref.decode_attention_split_ref(*args, split=128)
    want = args[2][:, C - 1].float().repeat_interleave(7, dim=1)
    assert torch.equal(got, want)


def _k6_inputs(B, d, V, seed, greedy):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) * 0.05).astype(np.float32)
    noise = np.zeros((B, V), np.float32) if greedy \
        else rng.gumbel(size=(B, V)).astype(np.float32)
    return y, table, noise


def _k6_both(y, table, noise, v_real, scale):
    """(port ids, port plain logits, reference interpret ids, oracle ids)"""
    t = [torch.from_numpy(a) for a in (y, table, noise)]
    got = ops.decode_sample(*t, scale=scale, v_real=v_real)
    logits = ref.decode_sample_logits(*t, scale=scale, v_real=v_real)
    j = [jnp.asarray(a) for a in (y, table, noise)]
    interp = np.asarray(jops.decode_sample(*j, scale=scale, v_real=v_real))
    oracle = np.asarray(jref.decode_sample_ref(*j, scale=scale,
                                               v_real=v_real))
    return got, logits, torch.from_numpy(interp.copy()), \
        torch.from_numpy(oracle.copy())


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("v_real", [8192, 8000, 2500])
@pytest.mark.parametrize("B", [1, 3])
def test_k6_plain_matches_reference(B, v_real, greedy):
    """V = 8192 in four blocks of 2048; v_real 2500 leaves three blocks
    wholly padded."""
    d, V = 112, 8192
    y, table, noise = _k6_inputs(B, d, V, seed=B * 7 + v_real, greedy=greedy)
    got, logits, interp, oracle = _k6_both(y, table, noise, v_real,
                                           d ** -0.5)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert int(got.max()) < v_real
    for other in (interp, oracle):
        ties, bad = ref.near_tie_check(logits, other, got, v_real)
        assert bad == 0 and ties <= 1, (ties, bad)
    # the walk over blocks is the first-index argmax of the masked logits
    assert torch.equal(got.long(), logits.argmax(dim=1))


@pytest.mark.parametrize("rows", [(100, 101), (100, 5000), (3, 8191)])
def test_k6_duplicated_rows_lower_index_wins(rows):
    """Two identical table rows that both beat every other row, with zero
    noise: their logits are equal and the lower index wins, within a block
    and across blocks, on the port and on the reference."""
    d, V = 112, 8192
    y, table, noise = _k6_inputs(2, d, V, seed=3, greedy=True)
    lo, hi = rows
    table[lo] = table[hi] = y[0] / np.linalg.norm(y[0]) * 4.0
    got, logits, interp, oracle = _k6_both(y, table, noise, V, d ** -0.5)
    assert float(logits[0, lo]) == float(logits[0, hi])
    for ids in (got, interp, oracle):
        assert int(ids[0]) == lo


def test_k6_masked_padded_id_never_wins():
    """A padded id (>= v_real) whose row would win by far if it were not
    masked loses to the best real id."""
    d, V, v_real = 112, 8192, 6000
    y, table, noise = _k6_inputs(3, d, V, seed=4, greedy=False)
    table[v_real + 17] = y[1] / np.linalg.norm(y[1]) * 50.0
    table[V - 1] = y[2] / np.linalg.norm(y[2]) * 50.0
    got, logits, interp, oracle = _k6_both(y, table, noise, v_real,
                                           d ** -0.5)
    unmasked = ref.decode_sample_ref(*(torch.from_numpy(a) for a in
                                       (y, table, noise)),
                                     scale=d ** -0.5, v_real=V)
    assert int(unmasked[1]) == v_real + 17 and int(unmasked[2]) == V - 1
    want = logits[:, :v_real].argmax(dim=1)
    for ids in (got, interp, oracle):
        assert torch.equal(ids.long(), want)


def test_near_tie_rule():
    """The rule itself: a flip inside τ is an exception, outside it a
    violation; ids >= v_real always violate."""
    lg = torch.tensor([[1.0, 1.0 + 1e-6, 0.0, 9.0],
                       [2.0, 1.0, 0.0, 9.0],
                       [2.0, 1.0, 0.0, 9.0]])
    want = torch.tensor([1, 0, 0])
    assert ref.near_tie_check(lg, torch.tensor([0, 0, 0]), want, 3) == (1, 0)
    assert ref.near_tie_check(lg, torch.tensor([1, 1, 0]), want, 3) == (0, 1)
    assert ref.near_tie_check(lg, torch.tensor([1, 0, 3]), want, 3) == (0, 1)


@pytest.mark.parametrize("bad", ["y_dtype", "noise_shape", "v_real",
                                 "B", "d"])
def test_k6_contract_raises(bad):
    y, table, noise = (torch.from_numpy(a) for a in
                       _k6_inputs(2, 112, 2048, seed=0, greedy=True))
    v_real = 2000
    if bad == "y_dtype":
        y = y.double()
    elif bad == "noise_shape":
        noise = noise[:, :1024].contiguous()
    elif bad == "v_real":
        v_real = 4096
    elif bad == "B":
        y, noise = torch.zeros((ds.BMAX + 1, 112)), \
            torch.zeros((ds.BMAX + 1, 2048))
    elif bad == "d":
        y, table = y[:, :110].contiguous(), table[:, :110].contiguous()
    with pytest.raises(ValueError):
        ops.decode_sample(y, table, noise, scale=1.0, v_real=v_real)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch only on CUDA tensors; the CPU route is
    ops.*, which runs the plain versions."""
    before = (ds.decode_attention.launches, ds.decode_sample.launches)
    q, k, v, bias = _k5_inputs(1, 4, 2, 8, 64, seed=0)
    with pytest.raises(ValueError, match="launches on CUDA tensors"):
        ds.decode_attention(torch.from_numpy(q), _bf16(k)[1], _bf16(v)[1],
                            torch.from_numpy(bias))
    y, table, noise = (torch.from_numpy(a) for a in
                       _k6_inputs(1, 112, 2048, seed=0, greedy=True))
    with pytest.raises(ValueError, match="launches on CUDA tensors"):
        ds.decode_sample(y, table, noise, scale=1.0, v_real=2048)
    assert (ds.decode_attention.launches, ds.decode_sample.launches) \
        == before
